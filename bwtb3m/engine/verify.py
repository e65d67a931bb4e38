"""Full-text BWT verification — equivalent of the ``checkbwt`` driver.

The reference verifier (/root/reference/src/checkbwt.cpp:27-241) walks the
entire text backwards via ``extendedLF`` on the rank structure, comparing
every emitted symbol against a circular-reverse read of the original text,
parallelized by splitting the rank space at ``.preisa`` samples. This is the
correctness oracle of the whole suite (SURVEY.md section 4.2).

Device redesign: the per-thread walks become *lanes* of one batched LF kernel —
all segments step simultaneously; each step is a batched rank query. A lane
whose segment is exhausted keeps stepping but its comparisons are masked.
"""

from __future__ import annotations

from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from ..ops.lf import lf_step_batch
from ..ops.rank import OccTable
from ..util.log import VerboseLog
from .result import BwtResult


def check_bwt(result: BwtResult, text: np.ndarray,
              num_lanes: int = 256, log: Optional[VerboseLog] = None) -> bool:
    """Verify that `result`'s .bwt + .preisa reproduce `text` exactly.

    Splits the walk at preisa samples into up to `num_lanes` lanes plus the
    preisa seeds themselves; returns True iff every one of the n emitted
    symbols equals the circular-reverse text read (reference prints gok=1,
    /root/reference/src/checkbwt.cpp)."""
    log = log or VerboseLog(0)
    n = len(text)
    text = np.asarray(text)
    sigma_t = int(text.max()) + 1 if n else 1
    if sigma_t <= 256 and result.sigma <= 256:
        return _check_bwt_fused(result, text, log, n)
    return _check_bwt_legacy(result, text, log, n)


def _check_bwt_fused(result: BwtResult, text: np.ndarray,
                     log: VerboseLog, n: int) -> bool:
    """FusedOcc walk: one row gather per LF step, text compared through
    phase-aligned row windows (one row gather per 256 steps per lane)
    instead of a per-step element gather.
    uint32 ranks: no 2^31 ceiling."""
    from ..ops.gapdev import build_text_rows, chunk_outer
    import time as _time

    _t0 = _time.time()
    focc, symmap = result.load_focc(dense=True)
    _t_focc = _time.time() - _t0
    if symmap is not None:
        remap = np.full(int(max(text.max(), symmap.max())) + 1, -1, np.int32)
        remap[symmap] = np.arange(len(symmap), dtype=np.int32)
        text = remap[np.asarray(text, dtype=np.int64)]
        if (text < 0).any():
            return False
    if int(focc.sigma) > 256:
        return _check_bwt_legacy(result, text, log, n)
    ranks, positions, _rate = result.load_preisa()
    order = np.argsort(positions)
    positions = positions[order]
    ranks = ranks[order]
    if len(positions) == 0 or positions[0] != 0:
        raise ValueError("preisa must contain a sample at position 0")
    seg_len = np.empty(len(positions), dtype=np.int64)
    if len(positions) == 1:
        seg_len[0] = n
    else:
        seg_len[0] = (positions[0] - positions[-1]) % n
        seg_len[1:] = positions[1:] - positions[:-1]
    assert seg_len.sum() == n, (seg_len.sum(), n)
    _write_checkinfo(result, seg_len, positions, ranks)

    sigma_t = int(text.max()) + 1 if n else 1
    _t0 = _time.time()
    text_rows = build_text_rows(text, sigma_t)
    _t_rows = _time.time() - _t0
    # lane i emits text[p_i - 1 - k] at step k; the wrap lane (p=0) reads
    # n-1 downward, so every lane's read positions stay in [0, n)
    walk_start = (positions - 1) % n
    aligned = ((walk_start + 256) // 256) * 256 - 1  # smallest =255 mod 256
    afrom = aligned - walk_start
    ato = afrom + seg_len
    T = len(positions)
    bucket = max(1024, 1 << (T - 1).bit_length())
    from ..ops.wideocc import WideOcc
    wide = isinstance(focc, WideOcc)
    sa = np.zeros(bucket, np.uint32)
    # wide path: lanes address text by absolute ROW (int32, < 2^25 at
    # 2^33 symbols) and carry (hi, lo) rank words — flat uint32 positions
    # wrap past 2^32
    sa[:T] = ((aligned >> 8) if wide else aligned).astype(np.uint32)
    af = np.zeros(bucket, np.int32)
    at = np.zeros(bucket, np.int32)
    af[:T] = afrom
    at[:T] = ato
    r = np.zeros(bucket, np.uint32)
    r[:T] = (ranks & 0xFFFFFFFF).astype(np.uint32)
    rj = jnp.asarray(r)
    if wide:
        rh = np.zeros(bucket, np.uint32)
        rh[:T] = (ranks >> 32).astype(np.uint32)
        rhj = jnp.asarray(rh)
    bad = jnp.zeros(bucket, jnp.int32)
    saj, afj, atj = jnp.asarray(sa), jnp.asarray(af), jnp.asarray(at)
    max_steps = int(ato.max())
    log.v("checkbwt walk: %d lanes (bucket %d), %d steps/lane max, "
          "focc %.1fs, text rows %.1fs" % (T, bucket, max_steps,
                                           _t_focc, _t_rows))
    _t0 = _time.time()
    done = 0
    while done < max_steps:
        outer = chunk_outer(max_steps - done)
        if wide:
            rhj, rj, bad = _verify_chunk_w(
                outer, focc, text_rows, saj, afj, atj, rhj, rj, bad,
                jnp.int32(done))
        else:
            rj, bad = _verify_chunk(outer, focc, text_rows, saj, afj, atj,
                                    rj, bad, jnp.int32(done))
        done += outer * 256
    total_bad = int(np.asarray(jnp.sum(bad)))
    log.v("checkbwt: %d mismatches over n=%d, walk %.1fs"
          % (total_bad, n, _time.time() - _t0))
    return total_bad == 0


def _write_checkinfo(result, seg_len, positions, ranks):
    # the role of the reference's .preisa.checkinfo thread-split file
    # (checkbwt.cpp:60-115): triples (segment length, start pos, start rank)
    try:
        info = np.empty((len(positions), 3), dtype="<u8")
        info[:, 0] = seg_len
        info[:, 1] = positions
        info[:, 2] = ranks
        with open(result.preisa_path + ".checkinfo", "wb") as f:
            f.write(info.tobytes())
    except OSError:
        pass  # read-only locations: the check itself proceeds


@partial(jax.jit, static_argnums=(0,), donate_argnums=(6, 7))
def _verify_chunk(outer: int, focc, text_rows, starts_al, afrom, ato,
                  r, bad, k0):
    from ..ops.focc import lf_step_batch_f

    def outer_body(carry, o):
        r, bad = carry
        kbase = k0 + o * 256
        off = starts_al - kbase.astype(jnp.uint32)
        prow = (off >> jnp.uint32(8)).astype(jnp.int32)
        trow = jnp.take(
            text_rows, jnp.minimum(prow, text_rows.shape[0] - 1), axis=0)

        def inner(i, carry):
            r, bad = carry
            k = kbase + i
            active = jnp.logical_and(k >= afrom, k < ato)
            sym, r2 = lf_step_batch_f(focc, r)
            col = 255 - i
            if trow.shape[1] == 128:
                # nibble-packed text rows (sigma <= 16)
                byte = lax.dynamic_slice_in_dim(
                    trow, col >> 1, 1, axis=1)[:, 0].astype(jnp.int32) & 0xFF
                expect = (byte >> ((col & 1) * 4)) & 0xF
            else:
                # & 0xFF: int8 text rows must not sign-extend for symbols
                # >= 128 (bytestream alphabets)
                expect = lax.dynamic_slice_in_dim(
                    trow, col, 1, axis=1)[:, 0].astype(jnp.int32) & 0xFF
            bad = bad + jnp.logical_and(
                active, sym != expect).astype(jnp.int32)
            r = jnp.where(active, r2, r)
            return (r, bad)

        r, bad = lax.fori_loop(0, 256, inner, (r, bad))
        return (r, bad), 0

    (r, bad), _ = lax.scan(outer_body, (r, bad),
                           jnp.arange(outer, dtype=jnp.int32))
    return r, bad


@partial(jax.jit, static_argnums=(0,), donate_argnums=(6, 7, 8))
def _verify_chunk_w(outer: int, w, text_rows, start_rows, afrom, ato,
                    r_hi, r_lo, bad, k0):
    """Wide-rank verify chunk for texts past 2^32 symbols: lanes carry
    (hi, lo) uint32 rank words through ops/wideocc.lf_step_batch_w, and
    the text window row is addressed relative to the lane's absolute
    start row (start_rows int32)."""
    from ..ops.wideocc import lf_step_batch_w

    def outer_body(carry, o):
        r_hi, r_lo, bad = carry
        kbase = k0 + o * 256
        prow = start_rows.astype(jnp.int32) - (kbase >> 8)
        trow = jnp.take(
            text_rows, jnp.minimum(jnp.maximum(prow, 0),
                                   text_rows.shape[0] - 1), axis=0)

        def inner(i, carry):
            r_hi, r_lo, bad = carry
            k = kbase + i
            active = jnp.logical_and(k >= afrom, k < ato)
            sym, h2, l2 = lf_step_batch_w(w, r_hi, r_lo)
            col = 255 - i
            if trow.shape[1] == 128:
                byte = lax.dynamic_slice_in_dim(
                    trow, col >> 1, 1, axis=1)[:, 0].astype(jnp.int32) & 0xFF
                expect = (byte >> ((col & 1) * 4)) & 0xF
            else:
                expect = lax.dynamic_slice_in_dim(
                    trow, col, 1, axis=1)[:, 0].astype(jnp.int32) & 0xFF
            bad = bad + jnp.logical_and(
                active, sym != expect).astype(jnp.int32)
            r_hi = jnp.where(active, h2, r_hi)
            r_lo = jnp.where(active, l2, r_lo)
            return (r_hi, r_lo, bad)

        carry = lax.fori_loop(0, 256, inner, (r_hi, r_lo, bad))
        return carry, 0

    (r_hi, r_lo, bad), _ = lax.scan(
        outer_body, (r_hi, r_lo, bad), jnp.arange(outer, dtype=jnp.int32))
    return r_hi, r_lo, bad


def _check_bwt_legacy(result: BwtResult, text: np.ndarray,
                      log: VerboseLog, n: int) -> bool:
    occt, symmap = result.load_occ(dense=True)
    if symmap is not None:
        # occ is over densified symbols; densify the text the same way
        remap = np.full(int(max(text.max(), symmap.max())) + 1, -1, np.int32)
        remap[symmap] = np.arange(len(symmap), dtype=np.int32)
        text = remap[np.asarray(text, dtype=np.int64)]
        if (text < 0).any():
            return False
    ranks, positions, _rate = result.load_preisa()

    # sort seeds by position; each seed walks back to the previous seed
    order = np.argsort(positions)
    positions = positions[order]
    ranks = ranks[order]
    if len(positions) == 0 or positions[0] != 0:
        raise ValueError("preisa must contain a sample at position 0")
    # segment for seed i: walk from (r_i, p_i) backwards to previous sample
    # (circularly, the first seed wraps to the last)
    seg_len = np.empty(len(positions), dtype=np.int64)
    seg_len[0] = (positions[0] - positions[-1]) % n
    if len(positions) > 1:
        seg_len[1:] = positions[1:] - positions[:-1]
    if len(positions) == 1:
        seg_len[0] = n
    assert seg_len.sum() == n, (seg_len.sum(), n)

    # persist the walk-segment records — the role of the reference's
    # .preisa.checkinfo thread-split file (checkbwt.cpp:60-115): triples
    # (segment length, start position, start rank) per lane
    try:
        info = np.empty((len(positions), 3), dtype="<u8")
        info[:, 0] = seg_len
        info[:, 1] = positions
        info[:, 2] = ranks
        with open(result.preisa_path + ".checkinfo", "wb") as f:
            f.write(info.tobytes())
    except OSError:
        pass  # read-only locations: the check itself proceeds

    steps = int(seg_len.max())
    # ship the text bit-packed when the (densified) alphabet is small
    import math as _math
    sigma_t = int(np.asarray(text).max()) + 1 if n else 1
    bits = max(1, _math.ceil(_math.log2(max(2, sigma_t))))
    if bits <= 8:
        from ..io.compact import pack_bits
        from ..ops.pack import unpack_bits_device
        text_dev = unpack_bits_device(
            jnp.asarray(pack_bits(np.asarray(text, np.int64), bits)), bits, n)
    else:
        text_dev = jnp.asarray(np.asarray(text, dtype=np.int32))
    r0 = jnp.asarray(ranks.astype(np.int32))
    p0 = jnp.asarray(positions.astype(np.int32))
    lens = jnp.asarray(seg_len.astype(np.int32))

    bad = _walk_verify_run(occt, text_dev, r0, p0, lens, steps)
    total_bad = int(np.asarray(bad).sum())
    log.v("checkbwt: %d mismatches over n=%d" % (total_bad, n))
    return total_bad == 0


@partial(jax.jit, static_argnums=(5,))
def _walk_verify_run(occt: OccTable, text: jnp.ndarray, r0: jnp.ndarray,
                     p0: jnp.ndarray, lens: jnp.ndarray, steps: int):
    n = text.shape[0]

    def body(j, carry):
        r, p, bad = carry
        sym, r2 = lf_step_batch(occt, r)
        pprev = jnp.where(p == 0, n - 1, p - 1)
        # single-element text read per lane: an element gather moves 4B
        # per lane vs 512B for a blocked row gather
        expect = jnp.take(text, pprev)
        active = j < lens
        bad = bad + jnp.logical_and(sym != expect, active).astype(jnp.int32)
        return (r2, pprev, bad)

    bad0 = jnp.zeros(r0.shape[0], jnp.int32)
    _r, _p, bad = lax.fori_loop(0, steps, body, (r0, p0, bad0))
    return bad

"""Sampled SA/ISA from .bwt + .preisa — equivalent of ``BwtComputeSSA``.

The reference tool bwtcomputessa (/root/reference/src/bwtcomputessa.cpp:51)
computes sampled SA and ISA in external memory from the run-length BWT and
the preisa rank/position seeds, without re-sorting. Device redesign: the seeds
become lanes of one batched LF walk — every lane steps simultaneously
(one batched rank query per step), harvesting
``SA[r] = p`` whenever ``r % sarate == 0`` and ``ISA[p] = r`` whenever
``p % isarate == 0`` via masked scatters. The external-memory radix-sort
passes of the reference become HBM-resident scatters.
"""

from __future__ import annotations

from functools import partial
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from ..io import formats
from ..ops.gapdev import chunk_outer
from ..ops.lf import lf_step_batch
from ..ops.rank import OccTable
from ..util.log import VerboseLog
from .result import BwtResult


@partial(jax.jit, static_argnums=(0, 6, 7), donate_argnums=(5,))
def _harvest_chunk(outer: int, focc, r, p0, lens, sa_out, n: int,
                   sarate: int, k0, isa_idx):
    """outer*256 LF steps for all lanes on the fused structure, harvesting
    SA entries with ONE masked scatter per chunk (pre-step ranks recorded
    through scan stacking — no per-step scatter, the round-1 bottleneck)
    and returning the pre-step ranks at the per-lane ISA-phase rows named
    by isa_idx."""
    from ..ops.focc import lf_step_batch_f

    sentinel = jnp.uint32(0xFFFFFFFF)

    def outer_body(r, o):
        kbase = k0 + o * 256

        def inner(r, i):
            k = kbase + i
            active = k < lens
            y = jnp.where(active, r, sentinel)
            _sym, r2 = lf_step_batch_f(focc, r)
            r = jnp.where(active, r2, r)
            return r, y

        return lax.scan(inner, r, jnp.arange(256, dtype=jnp.int32))

    r, ys = lax.scan(outer_body, r, jnp.arange(outer, dtype=jnp.int32))
    ys_flat = ys.reshape(outer * 256, r.shape[0])
    n_sa = sa_out.shape[0]
    if sarate == 1:
        idx = jnp.where(ys_flat == sentinel, jnp.uint32(n_sa), ys_flat)
    else:
        idx = jnp.where(ys_flat % jnp.uint32(sarate) == 0,
                        ys_flat // jnp.uint32(sarate), jnp.uint32(n_sa))
    kmat = lax.broadcasted_iota(jnp.int32, ys_flat.shape, 0) + k0
    pmat = p0[None, :] - kmat.astype(jnp.uint32)  # position at each step
    # circular wrap: the lane seeded at position 0 walks n-1, n-2, ... —
    # an unwrapped uint32 difference recorded positions off by 2^32 - n
    pmat = jnp.where(pmat >= jnp.uint32(n), pmat + jnp.uint32(n), pmat)
    # raw-u32 scatter: with sarate == 1 and n > 2^31 the indices exceed
    # int32 and an .at[].set(mode="drop") would silently drop every
    # sampled rank past 2^31
    from ..ops.idx64 import scatter_set_u32
    sa_out = scatter_set_u32(sa_out, idx, pmat)
    isa_vals = jnp.take_along_axis(ys_flat, isa_idx, axis=0)
    return r, sa_out, isa_vals


@partial(jax.jit, static_argnums=(0, 8, 9), donate_argnums=(6, 7))
def _harvest_chunk_w(outer: int, w, r_hi, r_lo, p_hi, p_lo, sa_lo, sa_hi,
                     n: int, sarate: int, lens, k0, isa_idx):
    """Wide-rank harvest chunk for texts past 2^32 symbols: lanes carry
    (hi, lo) uint32 rank words (ops/wideocc.lf_step_batch_w) and per-step
    positions are reconstructed two-word with explicit borrow/carry.
    sarate must be a power of two (two-word divmod stays bitwise).
    Returns (r_hi, r_lo, sa_lo, sa_hi, iv_hi, iv_lo)."""
    from ..ops.idx64 import scatter_set_u32
    from ..ops.wideocc import lf_step_batch_w

    sentinel = jnp.uint32(0xFFFFFFFF)

    def outer_body(carry, o):
        r_hi, r_lo = carry
        kbase = k0 + o * 256

        def inner(carry, i):
            r_hi, r_lo = carry
            k = kbase + i
            active = k < lens
            y_hi = jnp.where(active, r_hi, sentinel)
            y_lo = jnp.where(active, r_lo, sentinel)
            _sym, h2, l2 = lf_step_batch_w(w, r_hi, r_lo)
            r_hi = jnp.where(active, h2, r_hi)
            r_lo = jnp.where(active, l2, r_lo)
            return (r_hi, r_lo), (y_hi, y_lo)

        return lax.scan(inner, carry, jnp.arange(256, dtype=jnp.int32))

    (r_hi, r_lo), (ys_hi, ys_lo) = lax.scan(
        outer_body, (r_hi, r_lo), jnp.arange(outer, dtype=jnp.int32))
    T = r_lo.shape[0]
    ys_hi = ys_hi.reshape(outer * 256, T)
    ys_lo = ys_lo.reshape(outer * 256, T)
    if sarate:          # static: 0 = ISA-only walk, no SA harvest
        n_sa = sa_lo.shape[0]
        sh = jnp.uint32(sarate.bit_length() - 1)
        # rank % sarate == 0 (pow2: low bits of the lo word); idx =
        # rank >> sh is exact in uint32 because the driver rejects
        # n_sa >= 2^31 (so idx < 2^31 and hi < 2^(sh-1) — no bits lost
        # in the hi << (32 - sh) reassembly) for any n in the 2^35
        # engine envelope
        hit = jnp.logical_and((ys_lo & jnp.uint32(sarate - 1)) == 0,
                              ys_hi != sentinel)
        idx = jnp.where(hit,
                        (ys_hi << (jnp.uint32(32) - sh)) | (ys_lo >> sh),
                        jnp.uint32(n_sa))
        # position at each step: p0 - k two-word with borrow; the wrap
        # lane (p = 0) goes negative -> hi word wraps high -> add n back
        kmat = (lax.broadcasted_iota(jnp.int32, ys_lo.shape, 0)
                + k0).astype(jnp.uint32)
        pm_lo = p_lo[None, :] - kmat
        pm_hi = p_hi[None, :] - (pm_lo > p_lo[None, :]).astype(jnp.uint32)
        n_hi = jnp.uint32(n >> 32)
        n_lo = jnp.uint32(n & 0xFFFFFFFF)
        neg = jnp.logical_or(
            pm_hi > n_hi, jnp.logical_and(pm_hi == n_hi, pm_lo >= n_lo))
        add_lo = pm_lo + n_lo
        pm_hi = jnp.where(
            neg, pm_hi + n_hi + (add_lo < pm_lo).astype(jnp.uint32), pm_hi)
        pm_lo = jnp.where(neg, add_lo, pm_lo)
        sa_lo = scatter_set_u32(sa_lo, idx, pm_lo)
        sa_hi = scatter_set_u32(sa_hi, idx, pm_hi)
    iv_hi = jnp.take_along_axis(ys_hi, isa_idx, axis=0)
    iv_lo = jnp.take_along_axis(ys_lo, isa_idx, axis=0)
    return r_hi, r_lo, sa_lo, sa_hi, iv_hi, iv_lo


@partial(jax.jit, static_argnums=(4, 5, 6, 7))
def _harvest_walk(occt: OccTable, r0: jnp.ndarray, p0: jnp.ndarray,
                  lens: jnp.ndarray, steps: int, n: int,
                  sarate: int, isarate: int):
    n_sa = (n + sarate - 1) // sarate
    n_isa = (n + isarate - 1) // isarate
    sa_out = jnp.full((n_sa,), -1, jnp.int32)
    isa_out = jnp.full((n_isa,), -1, jnp.int32)

    def body(j, carry):
        r, p, sa_out, isa_out = carry
        active = j < lens
        # record current (r, p) state
        sa_idx = jnp.where(
            jnp.logical_and(active, r % sarate == 0), r // sarate, n_sa
        )
        sa_out = sa_out.at[sa_idx].set(p, mode="drop")
        isa_idx = jnp.where(
            jnp.logical_and(active, p % isarate == 0), p // isarate, n_isa
        )
        isa_out = isa_out.at[isa_idx].set(r, mode="drop")
        # step backwards
        _sym, r2 = lf_step_batch(occt, r)
        pprev = jnp.where(p == 0, n - 1, p - 1)
        r = jnp.where(active, r2, r)
        p = jnp.where(active, pprev, p)
        return (r, p, sa_out, isa_out)

    _r, _p, sa_out, isa_out = lax.fori_loop(
        0, steps, body, (r0, p0, sa_out, isa_out)
    )
    return sa_out, isa_out


def _harvest_fused_w(w, ranks, positions, seg_len, n, sarate, isarate):
    """Wide-rank harvest driver for texts past 2^32 symbols: lanes and
    harvested values are (hi, lo) uint32 pairs combined to int64 on host.
    Mirrors _harvest_fused; sarate must be a power of two >= 4 (or >= n
    to disable SA harvesting — compute_isa_from_preisa)."""
    T = len(positions)
    bucket = max(1024, 1 << (T - 1).bit_length())
    rl_ = np.zeros(bucket, np.uint32)
    rh_ = np.zeros(bucket, np.uint32)
    rl_[:T] = (ranks & 0xFFFFFFFF).astype(np.uint32)
    rh_[:T] = (ranks >> 32).astype(np.uint32)
    pl_ = np.zeros(bucket, np.uint32)
    ph_ = np.zeros(bucket, np.uint32)
    pl_[:T] = (positions & 0xFFFFFFFF).astype(np.uint32)
    ph_[:T] = (positions >> 32).astype(np.uint32)
    lens = np.zeros(bucket, np.int32)
    lens[:T] = seg_len
    if sarate >= n:
        k_sa, n_sa = 0, 1          # ISA-only walk
    else:
        if sarate < 4 or (sarate & (sarate - 1)):
            raise ValueError("texts past 2^32 need a power-of-two "
                             "sa sampling rate >= 4")
        k_sa = int(sarate)
        n_sa = (n + sarate - 1) // sarate
        if n_sa >= (1 << 31):
            raise ValueError("sampled SA exceeds 2^31 entries; raise "
                             "sasamplingrate")
    sa_lo = jnp.full(n_sa, 0xFFFFFFFF, jnp.uint32)
    sa_hi = jnp.full(n_sa, 0xFFFFFFFF, jnp.uint32)
    n_isa = (n + isarate - 1) // isarate
    isa_vals = np.full(n_isa, -1, np.int64)
    rlj, rhj = jnp.asarray(rl_), jnp.asarray(rh_)
    plj, phj = jnp.asarray(pl_), jnp.asarray(ph_)
    lj = jnp.asarray(lens)
    max_steps = int(seg_len.max())
    phase = positions % isarate
    phase = phase.copy()
    phase[0] = n % isarate
    isa_vals[0] = int(ranks[0])
    done = 0
    while done < max_steps:
        outer = chunk_outer(max_steps - done)
        chunklen = outer * 256
        nisa = chunklen // isarate + 1 if isarate <= chunklen else 1
        ks = ((phase - done) % isarate)[None, :] + \
            isarate * np.arange(nisa)[:, None]
        idx = np.zeros((nisa, bucket), np.int32)
        idx[:, :T] = np.minimum(ks, chunklen - 1)
        rhj, rlj, sa_lo, sa_hi, ivh, ivl = _harvest_chunk_w(
            outer, w, rhj, rlj, phj, plj, sa_lo, sa_hi, int(n), k_sa,
            lj, jnp.int32(done), jnp.asarray(idx))
        ivh = np.asarray(ivh)[:, :T].astype(np.int64)
        ivl = np.asarray(ivl)[:, :T].astype(np.int64)
        iv = (ivh << 32) | ivl
        kg = ks + done
        ok = (kg < seg_len[None, :]) & (ks < chunklen) & (kg >= done)
        pv = (positions[None, :] - kg)[ok] % n
        vv = iv[ok]
        good = ivh[ok] != 0xFFFFFFFF
        isa_vals[pv[good] // isarate] = vv[good]
        done += chunklen
    if k_sa:
        lo = np.asarray(sa_lo).astype(np.int64)
        hi = np.asarray(sa_hi).astype(np.int64)
        sa_vals = (hi << 32) | lo
        sa_vals[hi == 0xFFFFFFFF] = -1
    else:
        sa_vals = np.zeros(0, np.int64)
    return sa_vals, isa_vals


def _harvest_fused(focc, ranks, positions, seg_len, n, sarate, isarate):
    """Chunked fused-walk harvest driver. Returns (sa_vals, isa_vals)
    int64 host arrays (-1 where unvisited)."""
    from ..ops.wideocc import WideOcc
    if isinstance(focc, WideOcc):
        return _harvest_fused_w(focc, ranks, positions, seg_len, n,
                                sarate, isarate)
    T = len(positions)
    bucket = max(1024, 1 << (T - 1).bit_length())
    r = np.zeros(bucket, np.uint32)
    r[:T] = ranks.astype(np.uint32)
    p0 = np.zeros(bucket, np.uint32)
    p0[:T] = positions.astype(np.uint32)
    lens = np.zeros(bucket, np.int32)
    lens[:T] = seg_len
    n_sa = (n + sarate - 1) // sarate
    n_isa = (n + isarate - 1) // isarate
    sa_out = jnp.full(n_sa, 0xFFFFFFFF, jnp.uint32)
    isa_vals = np.full(n_isa, -1, np.int64)
    rj, p0j, lj = jnp.asarray(r), jnp.asarray(p0), jnp.asarray(lens)
    max_steps = int(seg_len.max())
    phase = positions % isarate  # k with p0 - k ≡ 0 (mod isarate)
    # lane 0 (seeded at position 0, _seed_segments sorts) wraps: its
    # positions are n - k for k >= 1, so its sampling grid is k ≡ n
    # (mod isarate); position 0 itself is the lane's own seed rank
    phase = phase.copy()
    phase[0] = n % isarate
    isa_vals[0] = int(ranks[0])
    done = 0
    while done < max_steps:
        outer = chunk_outer(max_steps - done)
        chunklen = outer * 256
        nisa = chunklen // isarate + 1 if isarate <= chunklen else 1
        ks = ((phase - done) % isarate)[None, :] + \
            isarate * np.arange(nisa)[:, None]
        idx = np.zeros((nisa, bucket), np.int32)
        idx[:, :T] = np.minimum(ks, chunklen - 1)
        rj, sa_out, iv = _harvest_chunk(
            outer, focc, rj, p0j, lj, sa_out, n, int(sarate),
            jnp.int32(done), jnp.asarray(idx))
        iv = np.asarray(iv)[:, :T]
        kg = ks + done
        ok = (kg < seg_len[None, :]) & (ks < chunklen) & (kg >= done)
        # circular wrap (the position-0 lane walks the text tail): without
        # the mod, negative host positions index isa_vals from the end
        pv = (positions[None, :] - kg)[ok] % n
        vv = iv[ok]
        good = vv != 0xFFFFFFFF
        isa_vals[pv[good] // isarate] = vv[good]
        done += chunklen
    sa_vals = np.asarray(sa_out).astype(np.int64)
    sa_vals[sa_vals == 0xFFFFFFFF] = -1
    return sa_vals, isa_vals


def _seed_segments(ranks: np.ndarray, positions: np.ndarray, n: int):
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
    assert seg_len.sum() == n
    return ranks, positions, seg_len


def compute_ssa(
    bwt_path: str,
    sa_sampling_rate: int = 32,
    isa_sampling_rate: int = 32,
    tmp_prefix: Optional[str] = None,
    copy_input_to_memory: bool = False,
    num_threads: int = 8,
    max_sort_mem: int = 2 * 1024 ** 3,
    max_tmp_files: int = 1024,
    log: Optional[VerboseLog] = None,
    ref_isa: Optional[str] = None,
    ref_sa: Optional[str] = None,
) -> Tuple[str, str]:
    """Produce ``<base>.sa`` and ``<base>.isa`` from ``<base>.bwt`` +
    ``<base>.preisa``. Signature mirrors ``BwtComputeSSA::computeSSA``
    (/root/reference/src/bwtcomputessa.cpp:51); the sort-memory / tmp-file
    arguments are accepted for CLI parity (the device path is resident).
    Optional ref_isa/ref_sa files are compared against, as in the
    reference's checking hooks (bwtcomputessa.cpp:48-49)."""
    log = log or VerboseLog(1)
    result = BwtResult.load(bwt_path)
    n = result.n
    ranks, positions, _rate = result.load_preisa()
    ranks, positions, seg_len = _seed_segments(ranks, positions, n)
    if result.sigma <= 256:
        import time as _time
        _t0 = _time.time()
        focc, _symmap = result.load_focc(dense=True)
        _t1 = _time.time()
        sa_vals, isa_vals = _harvest_fused(
            focc, ranks, positions, seg_len, n,
            int(sa_sampling_rate), int(isa_sampling_rate))
        log.v("ssa: %d lanes, focc %.1fs, walk+harvest %.1fs"
              % (len(positions), _t1 - _t0, _time.time() - _t1))
    else:
        occt, _symmap = result.load_occ(dense=True)
        steps = int(seg_len.max())
        sa_out, isa_out = _harvest_walk(
            occt,
            jnp.asarray(ranks.astype(np.int32)),
            jnp.asarray(positions.astype(np.int32)),
            jnp.asarray(seg_len.astype(np.int32)),
            steps, n, int(sa_sampling_rate), int(isa_sampling_rate),
        )
        sa_vals = np.asarray(sa_out, dtype=np.int64)
        isa_vals = np.asarray(isa_out, dtype=np.int64)
    if (sa_vals < 0).any() or (isa_vals < 0).any():
        raise AssertionError("LF walk failed to visit every sampled rank/position")

    base = bwt_path[:-4] if bwt_path.endswith(".bwt") else bwt_path
    sa_path, isa_path = base + ".sa", base + ".isa"
    formats.write_sampled_array(sa_path, sa_sampling_rate, sa_vals)
    formats.write_sampled_array(isa_path, isa_sampling_rate, isa_vals)
    log.v("wrote %s (%d values), %s (%d values)"
          % (sa_path, len(sa_vals), isa_path, len(isa_vals)))

    for ref_path, produced, kind in ((ref_sa, sa_vals, "sa"), (ref_isa, isa_vals, "isa")):
        if ref_path:
            _rrate, ref_vals = formats.read_sampled_array(ref_path)
            if len(ref_vals) != len(produced) or (ref_vals != produced).any():
                raise AssertionError("%s mismatch vs reference file %s" % (kind, ref_path))
            log.v("%s matches reference %s" % (kind, ref_path))
    return sa_path, isa_path


def compute_sa_device(bwt_path: str, log: Optional[VerboseLog] = None):
    """Rate-1 SA by LF walk, kept ON DEVICE: returns (sa_dev uint32 [n],
    n).  The device-resident PLCP path (lcp/plcp.py compute_plcp_device)
    derives ISA and Phi from it by device scatters instead of fetching
    this array and inverting it on the host."""
    log = log or VerboseLog(0)
    result = BwtResult.load(bwt_path)
    n = result.n
    if n >= (1 << 31) or result.sigma > 256:
        raise ValueError("compute_sa_device needs n < 2^31, sigma <= 256")
    ranks, positions, _rate = result.load_preisa()
    ranks, positions, seg_len = _seed_segments(ranks, positions, n)
    focc, _symmap = result.load_focc(dense=True)
    T = len(positions)
    bucket = max(1024, 1 << (T - 1).bit_length())
    r = np.zeros(bucket, np.uint32)
    r[:T] = ranks.astype(np.uint32)
    p0 = np.zeros(bucket, np.uint32)
    p0[:T] = positions.astype(np.uint32)
    lens = np.zeros(bucket, np.int32)
    lens[:T] = seg_len
    sa_out = jnp.full(n, 0xFFFFFFFF, jnp.uint32)
    rj, p0j, lj = jnp.asarray(r), jnp.asarray(p0), jnp.asarray(lens)
    idx0 = jnp.zeros((1, bucket), jnp.int32)
    max_steps = int(seg_len.max())
    done = 0
    while done < max_steps:
        outer = chunk_outer(max_steps - done)
        rj, sa_out, _iv = _harvest_chunk(
            outer, focc, rj, p0j, lj, sa_out, n, 1,
            jnp.int32(done), idx0)
        done += outer * 256
    return sa_out, n


def compute_isa_from_preisa(
    bwt_path: str, isa_sampling_rate: int = 64, log: Optional[VerboseLog] = None
) -> str:
    """hwtPreIsaToIsa equivalent (/root/reference/src/hwtPreIsaToIsa.cpp):
    .bwt + .preisa -> .isa at the requested rate. Runs the same batched walk
    but only harvests ISA samples."""
    log = log or VerboseLog(1)
    result = BwtResult.load(bwt_path)
    n = result.n
    ranks, positions, _rate = result.load_preisa()
    ranks, positions, seg_len = _seed_segments(ranks, positions, n)
    if result.sigma <= 256:
        focc, _ = result.load_focc(dense=True)
        # sa rate n: only rank 0 harvested (ignored)
        _sa_vals, isa_vals = _harvest_fused(
            focc, ranks, positions, seg_len, n, n,
            int(isa_sampling_rate))
    else:
        occt, _ = result.load_occ(dense=True)
        steps = int(seg_len.max())
        _sa_out, isa_out = _harvest_walk(
            occt,
            jnp.asarray(ranks.astype(np.int32)),
            jnp.asarray(positions.astype(np.int32)),
            jnp.asarray(seg_len.astype(np.int32)),
            steps, n, n, int(isa_sampling_rate),
        )
        isa_vals = np.asarray(isa_out, dtype=np.int64)
    if (isa_vals < 0).any():
        raise AssertionError("LF walk failed to reach every sampled position")
    base = bwt_path[:-4] if bwt_path.endswith(".bwt") else bwt_path
    isa_path = base + ".isa"
    formats.write_sampled_array(isa_path, isa_sampling_rate, isa_vals)
    log.v("wrote %s (%d values)" % (isa_path, len(isa_vals)))
    return isa_path


@partial(jax.jit, static_argnums=(0,))
def _select_chunk(outer: int, focc, bitwords, r, done, r_hit, k_hit, k0):
    """outer*256 masked LF steps for the select walk: a lane freezes the
    first time its current rank's bit is set in the preisa-rank bitmap,
    recording (rank, steps walked)."""
    from ..ops.focc import lf_step_batch_f
    from ..ops.idx64 import take_u32

    def outer_body(carry, o):
        kbase = k0 + o * 256

        def inner(carry, i):
            r, done, r_hit, k_hit = carry
            word = take_u32(bitwords, r >> jnp.uint32(5))
            bit = (word >> (r & jnp.uint32(31))) & jnp.uint32(1)
            hit = jnp.logical_and(jnp.logical_not(done), bit == 1)
            r_hit = jnp.where(hit, r, r_hit)
            k_hit = jnp.where(hit, (kbase + i).astype(jnp.uint32), k_hit)
            done = jnp.logical_or(done, hit)
            _sym, r2 = lf_step_batch_f(focc, r)
            r = jnp.where(done, r, r2)
            return (r, done, r_hit, k_hit), 0

        carry, _ = lax.scan(inner, carry,
                            jnp.arange(256, dtype=jnp.int32))
        return carry, 0

    carry, _ = lax.scan(outer_body, (r, done, r_hit, k_hit),
                        jnp.arange(outer, dtype=jnp.int32))
    return carry


def select_ssa(bwt_path: str, ranks: np.ndarray,
               log: Optional[VerboseLog] = None) -> np.ndarray:
    """SA values for an arbitrary set of ranks — ``BwtSelectSSA``
    equivalent (/root/reference/src/lcpbit.cpp:53,2417-2441: bitvector of
    wanted ranks -> (rank, pos) pairs), from ``.bwt`` + ``.preisa``
    ALONE (no sampled ``.sa`` prerequisite — the reference selects
    mid-lcpbit on a bwtonly=1 build).

    Device shape: the wanted ranks are walk lanes; a device bitmap marks
    the preisa ranks, and every lane LF-steps until its rank's bit is
    set (<= preisa-rate steps: preisa samples are position-equidistant,
    so a backward walk meets one within one sampling interval).  Then
    SA[wanted] = pos(hit rank) + steps, resolved on host against the
    preisa pairs.  Falls back to the sampled-SA locate for texts past
    2^32 (wide lanes) when a ``.sa`` exists."""
    log = log or VerboseLog(0)
    result = BwtResult.load(bwt_path)
    n = result.n
    ranks = np.asarray(ranks, dtype=np.int64)
    if (ranks < 0).any() or (ranks >= n).any():
        raise ValueError("ranks out of range")
    if n >= (1 << 32) or result.sigma > 256:
        from ..index.fm import FMIndex
        if result.sa_path is None:
            raise ValueError("select_ssa past 2^32 (or sigma > 256) "
                             "currently needs a sampled .sa")
        fm = FMIndex.from_bwt_result(result, structure="hwt")
        return fm.locate_batch(ranks)

    pr_ranks, pr_pos, prate = result.load_preisa()
    focc, _symmap = result.load_focc(dense=True)
    # device bitmap of preisa ranks
    words = np.zeros((n + 31) // 32, np.uint32)
    np.bitwise_or.at(words, pr_ranks >> 5,
                     np.uint32(1) << (pr_ranks & 31).astype(np.uint32))
    bitwords = jnp.asarray(words)
    T = len(ranks)
    bucket = max(1024, 1 << (T - 1).bit_length())
    r = np.zeros(bucket, np.uint32)
    r[:T] = ranks.astype(np.uint32)
    done = np.ones(bucket, bool)
    done[:T] = False
    rj = jnp.asarray(r)
    dj = jnp.asarray(done)
    rh = jnp.zeros(bucket, jnp.uint32)
    kh = jnp.zeros(bucket, jnp.uint32)
    k0 = 0
    max_steps = int(prate) + 256
    while True:
        outer = chunk_outer(max_steps)
        rj, dj, rh, kh = _select_chunk(outer, focc, bitwords, rj, dj,
                                       rh, kh, jnp.int32(k0))
        k0 += outer * 256
        if bool(np.asarray(jnp.all(dj))):
            break
        if k0 > 2 * (int(prate) + 512):
            raise AssertionError(
                "select walk exceeded the preisa sampling interval")
    r_hit = np.asarray(rh)[:T].astype(np.int64)
    k_hit = np.asarray(kh)[:T].astype(np.int64)
    order = np.argsort(pr_ranks)
    slot = np.searchsorted(pr_ranks[order], r_hit)
    assert (pr_ranks[order][slot] == r_hit).all()
    return (pr_pos[order][slot] + k_hit) % n

"""Device-resident merge-tree zip — gap-guided interleave of two region
BWTs entirely on device, plus the sample-rank helpers that replace the
host-fetched gap histogram.

Without it a large build is mostly host work: every level re-packs and
re-uploads the
right regions' BWT bytes to rebuild rank rows (`build_focc_host`),
downloads the byte-compressed gap (1 B/rank), zips on host
(`native.gap_interleave`) and re-uploads the merged bytes at the next
level.  This module keeps regions ON DEVICE between levels:

- a region's BWT lives as packed 2-D rows (int8 [nrows, 128] LSB-first
  nibbles for sigma <= 16, [nrows, 256] raw bytes otherwise — the same
  layout as the engine text rows, 2-D because int32 indexing reaches at
  most 2^31-1 per dimension);
- the merged region's rows are produced by a chunked interleave kernel
  reading the children's rows and the DEVICE gap histogram (uint16 or
  int32 [grows, 256]) — no host round-trip;
- the next level's rank rows build from these device rows through the
  shared chunk programs in ops/focc_build.py (no pack/upload);
- the right-side preisa sample updates (cnt_le at the sample ranks) are
  served by a tiny batched row-gather instead of the host reduceat over
  the fetched histogram.

Interleave semantics (the reference's gap-guided merge of two RL-BWT
streams, /root/reference/src/bwtb3m.cpp:62-63 phase 3 [libmaus2],
arXiv:1604.06687): for r = 0..B emit gap[r] left symbols, then (while
r < B) right[r].  Output position of right[r] is p_r = r + cnt_le[r]
(strictly increasing), so a chunk of output positions [t0, t0+CH) maps
to CONTIGUOUS ranges of right indices and left indices — each chunk is
a dense local scatter/gather with a local cumsum.  All rank/position arithmetic is uint32 (exact: the
device tree only runs for n < 2^32; wider texts keep the host path of
ops/gapwide.py).
"""

from __future__ import annotations

from functools import partial
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from .focc import _pad_rows
from .idx64 import take_u32

BLOCK = 256


def _bits_for(sigma: int) -> int:
    return 4 if sigma <= 16 else 8


def _row_w(bits: int) -> int:
    return BLOCK // 2 if bits == 4 else BLOCK


def rows_from_packed(packed, n: int, bits: int):
    """Device 1-D packed bytes (LSB-first nibbles for bits=4) -> padded
    2-D region rows int8 [nrows_pad, w].  nrows_pad is shape-bucketed so
    same-level regions share compiles."""
    w = _row_w(bits)
    nrows = max(1, (n + BLOCK - 1) // BLOCK)
    nrows_pad = _pad_rows(nrows)
    nbytes = nrows * w
    buf = jnp.zeros((nrows_pad, w), jnp.int8)
    # same-width reinterpret (astype u8->i8 would be a value conversion)
    p = lax.bitcast_convert_type(packed, jnp.int8)
    if p.shape[0] < nbytes:
        p = jnp.concatenate([p, jnp.zeros(nbytes - p.shape[0], jnp.int8)])
    return buf.at[:nrows].set(p[:nbytes].reshape(nrows, w))


def rows_from_host_bwt(bwt: np.ndarray, sigma: int):
    """Host uint8 BWT -> device region rows (packed transfer)."""
    bits = _bits_for(sigma)
    w = _row_w(bits)
    n = len(bwt)
    nrows = max(1, (n + BLOCK - 1) // BLOCK)
    b = np.asarray(bwt, np.uint8)
    pad = nrows * BLOCK - n
    if pad:
        b = np.concatenate([b, np.zeros(pad, np.uint8)])
    if bits == 4:
        from .. import native
        packed = native.pack_bits_u8(b, 4)
        if packed is None:
            from ..io.compact import pack_bits
            packed = np.asarray(pack_bits(b.astype(np.int64), 4), np.uint8)
        host = np.asarray(packed, np.uint8).reshape(nrows, w)
    else:
        host = b.reshape(nrows, w)
    nrows_pad = _pad_rows(nrows)
    if nrows_pad != nrows:
        full = np.zeros((nrows_pad, w), np.uint8)
        full[:nrows] = host
        host = full
    return jnp.asarray(host.view(np.int8))


def rows_to_host_bwt(rows, n: int, bits: int) -> np.ndarray:
    """Download region rows and unpack to host uint8 [n] (the final
    output materialization — ONE packed download for the whole build)."""
    nrows = max(1, (n + BLOCK - 1) // BLOCK)
    pk = np.asarray(rows[:nrows]).view(np.uint8).reshape(-1)
    if bits == 4:
        out = np.empty(len(pk) * 2, np.uint8)
        out[0::2] = pk & 0x0F
        out[1::2] = pk >> 4
        return out[:n]
    return pk[:n]


# --------------------------------------------------------------- gap sums

@jax.jit
def gap_row_cum_excl(gap) -> jnp.ndarray:
    """Exclusive cumulative row sums of the gap histogram: u32 [grows],
    row_cum[g] = sum of all cells in rows < g.  Exact for total < 2^32
    (int32-rerun cells enter as their unsigned bit patterns, which is
    what the mod-2^32 running sum needs)."""
    rs = jnp.sum(gap, axis=1, dtype=jnp.uint32)
    cum = jnp.cumsum(rs, dtype=jnp.uint32)
    return cum - rs


def _gap_cells_u32(rows_slice):
    return rows_slice.astype(jnp.uint32)


@partial(jax.jit, static_argnums=(0,))
def _count_right_before(iters: int, gap, row_cum, row0, cum_base, B, t):
    """For each t (u32 [K]): #r in [0, B) with r + cnt_le[r] < t, by
    binary search over the monotone F(r) = r + cnt_le[r].  row0/cum_base
    offset into a level-global histogram (batched levels); 0 for a
    per-pair gap."""
    K = t.shape[0]
    lo = jnp.zeros((K,), jnp.uint32)
    hi = jnp.broadcast_to(B.astype(jnp.uint32), (K,))
    col_iota = lax.broadcasted_iota(jnp.uint32, (K, BLOCK), 1)

    def body(_, lh):
        lo, hi = lh
        mid = lo + (hi - lo) // jnp.uint32(2)
        gr = row0 + (mid >> jnp.uint32(8))
        grow = _gap_cells_u32(take_u32(gap, gr))          # [K, 256]
        part = jnp.sum(jnp.where(col_iota <= (mid & jnp.uint32(255))[:, None],
                                 grow, jnp.uint32(0)), axis=1)
        cnt_le = take_u32(row_cum, gr) - cum_base + part
        f = mid + cnt_le
        less = f < t                                      # unsigned compare
        lo = jnp.where(less, mid + jnp.uint32(1), lo)
        hi = jnp.where(less, hi, mid)
        return lo, hi

    lo, hi = lax.fori_loop(0, iters, body, (lo, hi))
    return lo


def count_right_before(gap, row_cum, B: int, ts: np.ndarray,
                       row0: int = 0, cum_base=None) -> np.ndarray:
    """Host wrapper: #right symbols placed before each output position in
    ``ts``.  Pads ts to a power-of-two bucket for compile reuse."""
    if B == 0:
        return np.zeros(len(ts), np.int64)
    K = max(16, 1 << (len(ts) - 1).bit_length()) if len(ts) else 16
    tp = np.zeros(K, np.uint32)
    tp[: len(ts)] = np.asarray(ts, np.uint64).astype(np.uint32)
    if cum_base is None:
        cum_base = jnp.uint32(0)
    # fixed 33 iterations (covers any B < 2^32): one compile per shape
    out = _count_right_before(33, gap, row_cum, jnp.uint32(row0),
                              cum_base, jnp.uint32(B), jnp.asarray(tp))
    return np.asarray(out)[: len(ts)].astype(np.int64)


# ------------------------------------------------------------- interleave

def _unpack_rows(rows_k, bits: int):
    """[k, w] int8 gathered rows -> [k*256] int32 symbols."""
    k = rows_k.shape[0]
    if bits == 8:
        return (rows_k.astype(jnp.int32) & 0xFF).reshape(k * BLOCK)
    flat = rows_k.reshape(k * (BLOCK // 2))
    total = k * BLOCK
    arr = jnp.repeat(flat, 2, total_repeat_length=total)
    pos = lax.broadcasted_iota(jnp.int32, (total,), 0)
    return (arr.astype(jnp.int32) >> ((pos & 1) * 4)) & 0xF


def _zip_chunk_body(CH: int, bits: int, left_rows, right_rows, gap,
                    row_cum, out_rows, t0, r0, j0, B, row0, cum_base):
    """One output chunk [t0, t0+CH) of the merged BWT, written into
    out_rows in place.  r0 = #right before t0, j0 = t0 - r0.  Plain
    traceable body — called standalone (_zip_chunk) and per iteration
    of the fused whole-merge loop (_zip_all)."""
    from .pack import pack_bits_device
    krows = CH // BLOCK + 2

    # gap cells for r in [r0, r0+CH] (row gather tolerates tail clipping;
    # cells past B are masked below)
    gr0 = row0 + (r0 >> jnp.uint32(8))
    g_rows = take_u32(gap, gr0 + lax.broadcasted_iota(
        jnp.uint32, (krows,), 0))
    g_flat = _gap_cells_u32(g_rows).reshape(krows * BLOCK)
    off_r = (r0 & jnp.uint32(255)).astype(jnp.int32)
    cells = lax.dynamic_slice(g_flat, (off_r,), (CH + 1,))
    # cnt_le[r0-1]: full rows before gr0 plus the partial row before off_r
    first_row = _gap_cells_u32(take_u32(gap, gr0))
    iota256 = lax.broadcasted_iota(jnp.int32, (BLOCK,), 0)
    part0 = jnp.sum(jnp.where(iota256 < off_r, first_row, jnp.uint32(0)))
    cnt_le0 = take_u32(row_cum, gr0) - cum_base + part0
    csum = jnp.cumsum(cells, dtype=jnp.uint32)            # inclusive

    kk = lax.broadcasted_iota(jnp.uint32, (CH + 1,), 0)
    r_abs = r0 + kk
    p_local = (r_abs + cnt_le0 + csum) - t0               # u32, >= 0
    valid_r = r_abs < B
    idx = jnp.where(valid_r, jnp.minimum(p_local, jnp.uint32(CH)),
                    jnp.uint32(CH)).astype(jnp.int32)
    is_right = jnp.zeros((CH + 1,), jnp.int8).at[idx].set(jnp.int8(1))
    is_right = is_right[:CH]
    right_excl = jnp.cumsum(is_right.astype(jnp.int32)) - is_right

    # right symbols r0 + right_excl[i], left symbols j0 + (i - right_excl)
    r_gather = take_u32(right_rows, (r0 >> jnp.uint32(8))
                        + lax.broadcasted_iota(jnp.uint32, (krows,), 0))
    rsyms = _unpack_rows(r_gather, bits)
    l_gather = take_u32(left_rows, (j0 >> jnp.uint32(8))
                        + lax.broadcasted_iota(jnp.uint32, (krows,), 0))
    lsyms = _unpack_rows(l_gather, bits)
    i_iota = lax.broadcasted_iota(jnp.int32, (CH,), 0)
    rv = jnp.take(rsyms, off_r + right_excl)
    lv = jnp.take(lsyms, (j0 & jnp.uint32(255)).astype(jnp.int32)
                  + (i_iota - right_excl))
    out = jnp.where(is_right.astype(jnp.bool_), rv, lv)

    if bits == 4:
        chunk = lax.bitcast_convert_type(
            pack_bits_device(out, 4), jnp.int8).reshape(
            CH // BLOCK, BLOCK // 2)
    else:
        chunk = out.astype(jnp.int8).reshape(CH // BLOCK, BLOCK)
    row_t0 = (t0 >> jnp.uint32(8)).astype(jnp.int32)
    return lax.dynamic_update_slice(out_rows, chunk, (row_t0, 0))


_zip_chunk = partial(jax.jit, static_argnums=(0, 1), donate_argnums=(6,))(
    _zip_chunk_body)


def _zip_all_impl(CH: int, bits: int, left_rows, right_rows, gap, row_cum,
                  r_starts, out_rows, nchunks, B, row0, cum_base):
    """The WHOLE gap-guided interleave as ONE device program: a
    fori_loop over output chunks (dynamic trip count — one compile per
    (CH, bits, shapes), not per chunk count), instead of one dispatch
    per 2^24-symbol chunk (a 3.2 Gbp root merge has 191 chunks).
    r_starts = #right before each
    chunk start, precomputed on device by zip_plan/_count_right_before."""

    def body(c, orows):
        t0 = c.astype(jnp.uint32) * jnp.uint32(CH)
        r0 = jnp.take(r_starts, c)
        return _zip_chunk_body(CH, bits, left_rows, right_rows, gap,
                               row_cum, orows, t0, r0, t0 - r0, B, row0,
                               cum_base)

    return lax.fori_loop(0, nchunks, body, out_rows)


_zip_all = partial(jax.jit, static_argnums=(0, 1), donate_argnums=(7,))(
    _zip_all_impl)


def _chunk_size(total: int) -> int:
    """Static chunk length: <= 5 compile variants (x4 spacing bounds the
    last-chunk overshoot), each a multiple of 256, capped at 2^24: a
    larger chunk program's transients grow with the chunk."""
    for ch in (1 << 16, 1 << 18, 1 << 20, 1 << 22):
        if total <= ch:
            return ch
    return 1 << 24


def device_interleave(left_rows, A: int, right_rows, B: int, gap,
                      row_cum, bits: int, row0: int = 0,
                      cum_base=None, r_starts=None):
    """Merged region rows from the children's device rows + device gap.
    Returns int8 [nrows_pad, w] covering A+B symbols.  ``row0``/
    ``cum_base`` address a level-global histogram (batched levels);
    ``r_starts`` supplies precomputed chunk-start right counts (the
    fused zip_plan; host array or DEVICE u32 array) to skip the
    binary-search round trip.  The whole interleave runs as ONE
    dispatch (_zip_all)."""
    total = A + B
    CH = _chunk_size(total)
    nchunks = (total + CH - 1) // CH
    if r_starts is None:
        ts = np.arange(nchunks, dtype=np.int64) * CH
        r_starts = count_right_before_dev(gap, row_cum, B, ts, row0=row0,
                                          cum_base=cum_base)
    if isinstance(r_starts, np.ndarray):
        r_starts = jnp.asarray(
            np.asarray(r_starts, np.uint64).astype(np.uint32))
    w = _row_w(bits)
    # buffer must cover every chunk's FULL span: dynamic_update_slice
    # CLAMPS an out-of-range start, silently relocating the write — a
    # quarter-octave pad of the symbol rows alone is not chunk-aligned
    # once CH exceeds the pad granularity (measured corruption from
    # symbol 2^24 at CH=2^26)
    nrows_pad = _pad_rows(max(nchunks * (CH // BLOCK), 1))
    out_rows = jnp.zeros((nrows_pad, w), jnp.int8)
    if cum_base is None:
        cum_base = jnp.uint32(0)
    return _zip_all(CH, bits, left_rows, right_rows, gap, row_cum,
                    r_starts, out_rows, jnp.int32(nchunks),
                    jnp.uint32(B), jnp.uint32(row0), cum_base)


def count_right_before_dev(gap, row_cum, B: int, ts: np.ndarray,
                           row0: int = 0, cum_base=None):
    """count_right_before that KEEPS the result on device (u32 [Kpad]) —
    the fused zip consumes it there; no fetch round trip."""
    if B == 0:
        return jnp.zeros(max(16, len(ts)), jnp.uint32)
    K = max(16, 1 << (len(ts) - 1).bit_length()) if len(ts) else 16
    tp = np.zeros(K, np.uint32)
    tp[: len(ts)] = np.asarray(ts, np.uint64).astype(np.uint32)
    if cum_base is None:
        cum_base = jnp.uint32(0)
    return _count_right_before(33, gap, row_cum, jnp.uint32(row0),
                               cum_base, jnp.uint32(B), jnp.asarray(tp))


@partial(jax.jit, static_argnums=(0,))
def _zip_plan(iters: int, gap, row_cum, row0, cum_base, B, ts, ranks):
    total = jnp.sum(gap, dtype=jnp.uint32)[None]
    r_starts = _count_right_before(iters, gap, row_cum, row0, cum_base,
                                   B, ts)
    cnt = _cnt_le_at(gap, row_cum, row0, cum_base, ranks)
    return jnp.concatenate([total, r_starts, cnt])


def zip_plan_dispatch(gap, row_cum, B: int, ts: np.ndarray,
                      ranks: np.ndarray, row0: int = 0, cum_base=None):
    """Dispatch half of zip_plan (no sync): returns an opaque handle.
    Dispatching every pair's plan before fetching any keeps a batched
    level's plan fetches from queueing behind another pair's zip
    programs on the device's in-order stream."""
    Kt = max(16, 1 << (len(ts) - 1).bit_length()) if len(ts) else 16
    tp = np.zeros(Kt, np.uint32)
    tp[: len(ts)] = np.asarray(ts, np.uint64).astype(np.uint32)
    Kr = max(16, 1 << (len(ranks) - 1).bit_length()) if len(ranks) else 16
    rp = np.zeros(Kr, np.uint32)
    rp[: len(ranks)] = np.asarray(ranks, np.uint64).astype(np.uint32)
    if cum_base is None:
        cum_base = jnp.uint32(0)
    out_dev = _zip_plan(33, gap, row_cum, jnp.uint32(row0),
                        cum_base, jnp.uint32(B), jnp.asarray(tp),
                        jnp.asarray(rp))
    return out_dev, Kt, len(ts), len(ranks)


def zip_plan_fetch(handle):
    """Fetch half of zip_plan: (total, r_starts DEVICE u32, cnt_le)."""
    out_dev, Kt, nt, nr = handle
    out = np.asarray(out_dev, np.int64)
    total = int(np.uint32(out[0]))
    # r_starts returns as the DEVICE u32 slice: the fused zip (_zip_all)
    # consumes it there; the host copy rides along in the same fetch
    r_starts = out_dev[1 : 1 + Kt]
    cnt = out[1 + Kt : 1 + Kt + nr]
    return total, r_starts, cnt


def zip_plan(gap, row_cum, B: int, ts: np.ndarray, ranks: np.ndarray,
             row0: int = 0, cum_base=None):
    """The merge tail's host-needed scalars in ONE dispatch + ONE fetch:
    (checksum total, #right before each chunk start, cnt_le at the
    right-side sample ranks).  Replaces three separate dispatch+fetch
    round trips (gap_checksum / count_right_before / cnt_le_at_ranks)
    with one."""
    return zip_plan_fetch(
        zip_plan_dispatch(gap, row_cum, B, ts, ranks, row0=row0,
                          cum_base=cum_base))


# ------------------------------------------------- wide (hi, lo) variants
#
# Texts past 2^32 symbols (ops/gapwide.py merges) exceed uint32 in both
# the rank space and the output positions, so the zip's big quantities
# travel as (hi, lo) uint32 pairs, so the package keeps jax_enable_x64
# off and every device quantity 32-bit.
# Two observations keep the kernels almost identical to the narrow ones:
#
# 1. cumulative row sums only need a pair-valued associative scan with an
#    explicit carry (per-row sums decompose as sum(cell & 0xFFFF) +
#    sum(cell >> 16) << 16, each < 2^24 for 256 cells);
# 2. within one output chunk of CH <= 2^24 symbols every quantity the
#    kernel compares or scatters is a DIFFERENCE bounded by CH, so the
#    mod-2^32 lo words subtract to the exact small value — the chunk
#    kernel runs on lo words alone, with the host pre-resolving each
#    chunk's right-index range (nvalid) through the wide binary search.
#
# Reference role: the uniform any-n gap-guided merge,
# /root/reference/src/bwtb3m.cpp:47,62-63 [libmaus2].


def _pair_add(ah, al, bh, bl):
    lo = al + bl
    return ah + bh + (lo < al).astype(jnp.uint32), lo


def _pair_sub(ah, al, bh, bl):
    """a - b for a >= b."""
    return ah - bh - (al < bl).astype(jnp.uint32), al - bl


def _pair_lt(ah, al, bh, bl):
    return jnp.logical_or(ah < bh, jnp.logical_and(ah == bh, al < bl))


def _row_sums_pair(rows_u32):
    """Exact per-row sums of [*, 256] u32 cells as (hi, lo) pairs."""
    s1 = jnp.sum(rows_u32 & jnp.uint32(0xFFFF), axis=-1,
                 dtype=jnp.uint32)                       # < 2^24
    s2 = jnp.sum(rows_u32 >> jnp.uint32(16), axis=-1,
                 dtype=jnp.uint32)                       # < 2^24
    low = (s2 << jnp.uint32(16)) + s1
    hi = (s2 >> jnp.uint32(16)) + (low < s1).astype(jnp.uint32)
    return hi, low


@jax.jit
def gap_row_cum_excl_w(gap):
    """Exclusive cumulative row sums as (hi, lo) u32 arrays [grows] —
    exact for totals to 2^39 (the wide scatter-row envelope)."""
    rs_hi, rs_lo = _row_sums_pair(gap.astype(jnp.uint32))
    cum_hi, cum_lo = lax.associative_scan(
        lambda a, b: _pair_add(a[0], a[1], b[0], b[1]), (rs_hi, rs_lo))
    return _pair_sub(cum_hi, cum_lo, rs_hi, rs_lo)


@jax.jit
def _gap_total_pair(gap):
    rs_hi, rs_lo = _row_sums_pair(gap.astype(jnp.uint32))
    cum_hi, cum_lo = lax.associative_scan(
        lambda a, b: _pair_add(a[0], a[1], b[0], b[1]), (rs_hi, rs_lo))
    return cum_hi[-1], cum_lo[-1]


def gap_checksum_w(gap) -> int:
    """Exact int64 histogram total ON DEVICE (pair reduction) — the wide
    runner's checksum without fetching the byte-compressed histogram."""
    h, l = _gap_total_pair(gap)
    return (int(h) << 32) | int(l)


def _masked_row_sum_pair(grow_u32, col_limit):
    """Per-row (hi, lo) sum of cells with column <= col_limit[:, None]."""
    col = lax.broadcasted_iota(jnp.uint32, grow_u32.shape, 1)
    masked = jnp.where(col <= col_limit[:, None], grow_u32, jnp.uint32(0))
    return _row_sums_pair(masked)


@partial(jax.jit, static_argnums=(0,))
def _count_right_before_w(iters: int, gap, cum_hi, cum_lo, row0,
                          cb_hi, cb_lo, B_hi, B_lo, t_hi, t_lo):
    """Wide binary search: #r with r + cnt_le[r] < t, all pairs."""
    K = t_lo.shape[0]
    lo_h = jnp.zeros((K,), jnp.uint32)
    lo_l = jnp.zeros((K,), jnp.uint32)
    hi_h = jnp.broadcast_to(B_hi, (K,))
    hi_l = jnp.broadcast_to(B_lo, (K,))

    def body(_, st):
        lo_h, lo_l, hi_h, hi_l = st
        d_h, d_l = _pair_sub(hi_h, hi_l, lo_h, lo_l)
        h_h = d_h >> jnp.uint32(1)
        h_l = (d_l >> jnp.uint32(1)) | (d_h << jnp.uint32(31))
        m_h, m_l = _pair_add(lo_h, lo_l, h_h, h_l)
        gr = row0 + ((m_h << jnp.uint32(24))
                     | (m_l >> jnp.uint32(8))).astype(jnp.int32)
        grow = take_u32(gap, gr).astype(jnp.uint32)       # [K, 256]
        p_h, p_l = _masked_row_sum_pair(grow, m_l & jnp.uint32(255))
        c_h, c_l = _pair_sub(take_u32(cum_hi, gr), take_u32(cum_lo, gr),
                             cb_hi, cb_lo)
        c_h, c_l = _pair_add(c_h, c_l, p_h, p_l)
        f_h, f_l = _pair_add(m_h, m_l, c_h, c_l)
        less = _pair_lt(f_h, f_l, t_hi, t_lo)
        n_h, n_l = _pair_add(m_h, m_l, jnp.uint32(0), jnp.uint32(1))
        lo_h = jnp.where(less, n_h, lo_h)
        lo_l = jnp.where(less, n_l, lo_l)
        hi_h = jnp.where(less, hi_h, m_h)
        hi_l = jnp.where(less, hi_l, m_l)
        return lo_h, lo_l, hi_h, hi_l

    lo_h, lo_l, _hh, _hl = lax.fori_loop(
        0, iters, body, (lo_h, lo_l, hi_h, hi_l))
    return lo_h, lo_l


def count_right_before_w(gap, row_cum, B: int, ts: np.ndarray,
                         row0: int = 0, cum_base=(0, 0)) -> np.ndarray:
    """Host wrapper of the wide search; ts/return are int64."""
    if B == 0:
        return np.zeros(len(ts), np.int64)
    cum_hi, cum_lo = row_cum
    K = max(16, 1 << (len(ts) - 1).bit_length()) if len(ts) else 16
    t = np.zeros(K, np.uint64)
    t[: len(ts)] = np.asarray(ts, np.uint64)
    cb_h, cb_l = cum_base
    lo_h, lo_l = _count_right_before_w(
        36, gap, cum_hi, cum_lo, jnp.int32(row0),
        jnp.uint32(int(cb_h)), jnp.uint32(int(cb_l)),
        jnp.uint32(B >> 32), jnp.uint32(B & 0xFFFFFFFF),
        jnp.asarray((t >> np.uint64(32)).astype(np.uint32)),
        jnp.asarray((t & np.uint64(0xFFFFFFFF)).astype(np.uint32)))
    out = (np.asarray(lo_h, np.int64) << 32) | np.asarray(lo_l, np.int64)
    return out[: len(ts)]


def _zip_chunk_w_impl(CH: int, bits: int, left_rows, right_rows, gap,
                      cum_lo, out_rows, gr0, rrow0, lrow0, row_t0,
                      r0_lo, j0_col, t0_lo, nvalid, cb_lo):
    """Wide output chunk: identical placement logic to _zip_chunk_impl on
    mod-2^32 lo words; validity comes from the host-resolved right-index
    count ``nvalid`` (for r inside the chunk the true relative position
    is < CH, so the u32 arithmetic is exact; r beyond it must be DROPPED
    by count, not clipped by magnitude — their wrapped lo words could
    alias into [0, CH))."""
    from .pack import pack_bits_device
    krows = CH // BLOCK + 2
    kiota = lax.broadcasted_iota(jnp.int32, (krows,), 0)

    g_rows = take_u32(gap, gr0 + kiota)
    g_flat = g_rows.astype(jnp.uint32).reshape(krows * BLOCK)
    off_r = (r0_lo & jnp.uint32(255)).astype(jnp.int32)
    cells = lax.dynamic_slice(g_flat, (off_r,), (CH + 1,))
    first_row = take_u32(gap, gr0).astype(jnp.uint32)
    iota256 = lax.broadcasted_iota(jnp.int32, (BLOCK,), 0)
    part0 = jnp.sum(jnp.where(iota256 < off_r, first_row, jnp.uint32(0)))
    cnt_le0 = take_u32(cum_lo, gr0) - cb_lo + part0      # mod 2^32
    csum = jnp.cumsum(cells, dtype=jnp.uint32)

    kk = lax.broadcasted_iota(jnp.uint32, (CH + 1,), 0)
    p_local = (r0_lo + kk + cnt_le0 + csum) - t0_lo      # exact for kk<nvalid
    valid_r = kk < nvalid
    idx = jnp.where(valid_r, jnp.minimum(p_local, jnp.uint32(CH)),
                    jnp.uint32(CH)).astype(jnp.int32)
    is_right = jnp.zeros((CH + 1,), jnp.int8).at[idx].set(jnp.int8(1))
    is_right = is_right[:CH]
    right_excl = jnp.cumsum(is_right.astype(jnp.int32)) - is_right

    r_gather = take_u32(right_rows, rrow0 + kiota)
    rsyms = _unpack_rows(r_gather, bits)
    l_gather = take_u32(left_rows, lrow0 + kiota)
    lsyms = _unpack_rows(l_gather, bits)
    i_iota = lax.broadcasted_iota(jnp.int32, (CH,), 0)
    rv = jnp.take(rsyms, off_r + right_excl)
    lv = jnp.take(lsyms, j0_col + (i_iota - right_excl))
    out = jnp.where(is_right.astype(jnp.bool_), rv, lv)

    if bits == 4:
        chunk = lax.bitcast_convert_type(
            pack_bits_device(out, 4), jnp.int8).reshape(
            CH // BLOCK, BLOCK // 2)
    else:
        chunk = out.astype(jnp.int8).reshape(CH // BLOCK, BLOCK)
    return lax.dynamic_update_slice(out_rows, chunk, (row_t0, 0))


_zip_chunk_w = partial(jax.jit, static_argnums=(0, 1),
                       donate_argnums=(6,))(_zip_chunk_w_impl)


def device_interleave_w(left_rows, A: int, right_rows, B: int, gap,
                        row_cum, bits: int):
    """Wide merged region rows (A + B may exceed 2^32).  ``row_cum`` is
    the (hi, lo) pair from gap_row_cum_excl_w."""
    total = A + B
    CH = _chunk_size(total)
    nchunks = (total + CH - 1) // CH
    ts = np.arange(nchunks + 1, dtype=np.int64) * CH
    ts[-1] = total
    r_b = count_right_before_w(gap, row_cum, B, ts)
    r_b[-1] = B                     # all right symbols precede the end
    w = _row_w(bits)
    # chunk-aligned buffer (see device_interleave: a clamped
    # dynamic_update_slice start silently relocates the write)
    nrows_pad = _pad_rows(max(nchunks * (CH // BLOCK), 1))
    out_rows = jnp.zeros((nrows_pad, w), jnp.int8)
    cum_lo = row_cum[1]
    for c in range(nchunks):
        t0 = int(ts[c])
        r0 = int(r_b[c])
        j0 = t0 - r0
        nvalid = int(min(r_b[c + 1], B) - r0)
        out_rows = _zip_chunk_w(
            CH, bits, left_rows, right_rows, gap, cum_lo, out_rows,
            jnp.int32(r0 >> 8), jnp.int32(r0 >> 8), jnp.int32(j0 >> 8),
            jnp.int32(t0 >> 8), jnp.uint32(r0 & 0xFFFFFFFF),
            jnp.int32(j0 & 0xFF), jnp.uint32(t0 & 0xFFFFFFFF),
            jnp.uint32(nvalid), jnp.uint32(0))
    return out_rows


@jax.jit
def _cnt_le_at_w(gap, cum_hi, cum_lo, gr, cols):
    grow = take_u32(gap, gr).astype(jnp.uint32)
    p_h, p_l = _masked_row_sum_pair(grow, cols)
    return _pair_add(take_u32(cum_hi, gr), take_u32(cum_lo, gr), p_h, p_l)


def cnt_le_at_ranks_w(gap, row_cum, ranks: np.ndarray) -> np.ndarray:
    """Wide cnt_le[r] (inclusive) at int64 ranks."""
    if len(ranks) == 0:
        return np.zeros(0, np.int64)
    cum_hi, cum_lo = row_cum
    K = max(16, 1 << (len(ranks) - 1).bit_length())
    r = np.zeros(K, np.uint64)
    r[: len(ranks)] = np.asarray(ranks, np.uint64)
    h, l = _cnt_le_at_w(
        gap, cum_hi, cum_lo,
        jnp.asarray((r >> np.uint64(8)).astype(np.int32)),
        jnp.asarray((r & np.uint64(255)).astype(np.uint32)))
    out = (np.asarray(h, np.int64) << 32) | np.asarray(l, np.int64)
    return out[: len(ranks)]


# --------------------------------------------------------- sample updates

@jax.jit
def _cnt_le_at(gap, row_cum, row0, cum_base, ranks):
    gr = row0 + (ranks >> jnp.uint32(8))
    grow = _gap_cells_u32(take_u32(gap, gr))
    col = lax.broadcasted_iota(jnp.uint32, grow.shape, 1)
    part = jnp.sum(jnp.where(col <= (ranks & jnp.uint32(255))[:, None],
                             grow, jnp.uint32(0)), axis=1)
    return take_u32(row_cum, gr) - cum_base + part


def cnt_le_at_ranks(gap, row_cum, ranks: np.ndarray, row0: int = 0,
                    cum_base=None) -> np.ndarray:
    """cnt_le[r] (inclusive) at the given ranks, via one batched row
    gather — replaces the host reduceat over the fetched histogram for
    the right-side preisa sample updates."""
    if len(ranks) == 0:
        return np.zeros(0, np.int64)
    K = max(16, 1 << (len(ranks) - 1).bit_length())
    rp = np.zeros(K, np.uint32)
    rp[: len(ranks)] = np.asarray(ranks, np.uint64).astype(np.uint32)
    if cum_base is None:
        cum_base = jnp.uint32(0)
    out = _cnt_le_at(gap, row_cum, jnp.uint32(row0), cum_base,
                     jnp.asarray(rp))
    return np.asarray(out)[: len(ranks)].astype(np.int64)

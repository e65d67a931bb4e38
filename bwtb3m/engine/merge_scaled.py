"""Scaled blockwise BWT construction — regions as (BWT + samples), no
full suffix arrays, device-resident chains.

This is the memory-bounded engine that reaches reference scale (the
round-1 blockwise engine in engine/merge.py keeps every region's full SA
and ISA on the host and stages text chunks per step; fine to ~10^8, fatal
at 3.2 Gbp).  Matching the reference's design (SURVEY.md section 3.1,
arXiv:1604.06687), a region here carries only:

    bwt          host uint8, the region's rotation-order BWT
    samples      (pos, local rank) at preisa-rate-aligned positions
    r_start      local rank of the rotation starting at the region start
    hist         symbol histogram of text[s:e]

Per pair merge the right side's BWT is shipped to the device (4-bit
packed), its FusedOcc built there, gap chains run fully on device
(ops/gapdev.py), the byte-compressed gap histogram is fetched, and the
zip happens in native C++ (c_gap_interleave).  Sample ranks update in
O(#samples): a left suffix p gains R(p) (harvested from the chain
recording), a right rank r gains cnt_le[r] (one device gather).

The merge tree keeps every right region below 2^31 rotations for texts up
to 2^32-1 symbols, so device rank arithmetic stays int32; host bookkeeping
is int64 throughout (reference: bwtb3m.cpp:47,53 — the mem= bound and
sparse external gap files whose role the device/host split takes over).
"""

from __future__ import annotations

import dataclasses
import functools
import os
from typing import List, Optional, Tuple

import numpy as np

from ..ops.gapdev import DeviceGapRunner, build_text_rows
from ..ops.focc_build import build_focc_host
from ..util.devmem import device_budget
from ..util.log import VerboseLog
from .options import BwtOptions


@dataclasses.dataclass
class _RegionS:
    s: int
    e: int
    bwt: Optional[np.ndarray]  # uint8 [e-s]; None while device-resident
    samp_pos: np.ndarray     # int64, ascending
    samp_rank: np.ndarray    # int64 local ranks
    r_start: int             # local rank of rotation s
    hist: np.ndarray         # int64 [sigma] of text[s:e]
    rows: object = None      # device packed rows (ops/devzip.py layout)


@dataclasses.dataclass
class DeviceRowsHandle:
    """Identity-carrying hand-off of the final region's device rows.

    ``blockwise_bwt_scaled`` fills one of these (when the caller passes
    ``rows_out``) instead of stashing rows in module state: the handle
    names the build it came from (n, sigma, histogram fingerprint), so
    the registration layer (engine/result.py:register_device_rows) can
    refuse to bind rows to a ``.bwt`` they do not belong to.  This
    replaces the round-4 ``_LAST_BUILD_ROWS`` global, which bound one
    text's rank rows to a different text's output when two builds ran
    in one process."""

    rows: object
    n: int
    sigma: int
    hist: np.ndarray  # int64 [sigma] — the BWT's symbol histogram


class _Hole:
    """Placeholder for a tree node fully covered by a saved ancestor
    region at resume: it occupies the node's slot in the level lists so
    positional pairing stays aligned, and is never computed."""

    def __init__(self, s: int, e: int):
        self.s, self.e = s, e


def _load_saved(ctx: "_Ctx", avail, s: int, e: int) -> _RegionS:
    """Materialize a checkpointed region (engine/checkpoint.py)."""
    from .checkpoint import load_region_file
    data = load_region_file(avail[(s, e)], ctx._ckpt_key)
    if data is None:
        raise RuntimeError(
            "unreadable/stale checkpoint %s — remove it and restart"
            % avail[(s, e)])
    _s, _e, bwt, samp_pos, samp_rank, r_start, hist = data
    return _RegionS(s, e, bwt, np.asarray(samp_pos, np.int64),
                    np.asarray(samp_rank, np.int64), r_start,
                    np.asarray(hist, np.int64))


def _bwt_getter(ctx: "_Ctx", reg: _RegionS):
    """Zero-arg host-BWT materializer for the checkpoint worker thread:
    captures the device rows so the packed download happens off the
    compute thread (and caches back onto the region)."""
    if reg.bwt is not None:
        b = reg.bwt
        return lambda: b
    rows, n, bits = reg.rows, reg.e - reg.s, ctx.bits

    def get():
        from ..ops.devzip import rows_to_host_bwt
        return rows_to_host_bwt(rows, n, bits)

    return get


def _region_rows(ctx: "_Ctx", reg: _RegionS):
    """Device packed rows of a region's BWT, built from the host bytes
    on first use (only pre-device-tree callers ever hit the build)."""
    if reg.rows is None:
        from ..ops.devzip import rows_from_host_bwt
        reg.rows = rows_from_host_bwt(reg.bwt, ctx.sigma)
    return reg.rows


def _region_bwt(ctx: "_Ctx", reg: _RegionS) -> np.ndarray:
    """Host BWT bytes of a region, downloaded from the device rows on
    first use (final output materialization; wide/mesh fallbacks)."""
    if reg.bwt is None:
        from ..ops.devzip import rows_to_host_bwt
        reg.bwt = rows_to_host_bwt(reg.rows, reg.e - reg.s, ctx.bits)
    return reg.bwt


class _Ctx:
    def __init__(self, text: np.ndarray, sigma: int, rate: int,
                 options: BwtOptions, log: VerboseLog,
                 lane_bucket: int, nthreads: int = 4, mesh=None):
        self.text = np.ascontiguousarray(text, dtype=np.uint8)
        self.n = len(text)
        self.sigma = sigma
        self.rate = rate
        self.options = options
        self.log = log
        self.lane_bucket = lane_bucket
        self.nthreads = nthreads
        self.mesh = mesh        # jax Mesh: shard chain lanes per merge
        self.text_rows = build_text_rows(self.text, sigma)
        self.bits = 4 if sigma <= 16 else 8
        # device-resident merge tree (round 4): regions stay on device
        # as packed rows between levels — no per-level host pack/upload
        # of rank rows, no gap download, no host zip.  Off under a mesh
        # (the sharded runners own the gap layout) and for wide merges.
        self.device_tree = (mesh is None
                            and os.environ.get("BWTB3M_DEVICE_TREE", "1")
                            != "0")


def _plan_blocks_fixed(n: int, max_block: int) -> List[Tuple[int, int]]:
    """Fixed-size blocks + a short tail. The block size depends only on
    ``max_block`` (not on n), so different text lengths built with the
    same mem target reuse the same compiled sort shapes — each new shape
    is one more compile."""
    size = max(256, (min(max_block, n) // 256) * 256)
    out = []
    s = 0
    while s < n:
        out.append((s, min(n, s + size)))
        s += size
    return out


def _rows_slice_symbols(ctx: _Ctx, a: int, b: int):
    """text[a:b) as int32 device array, decoded from the 2-D device rows
    (0 <= a < b <= n). Row-granular slicing first — the rows must never
    be viewed 1-D (int32 indexing reaches at most 2^31-1 per dimension); the
    local slice is far below 2^31 and may flatten freely."""
    import jax.numpy as jnp
    from jax import lax
    r0, r1 = a >> 8, (b + 255) >> 8
    sl = ctx.text_rows[r0:r1]
    if ctx.bits == 4:
        bts = (sl.reshape(-1).astype(jnp.int32)) & 0xFF
        total = bts.shape[0] * 2
        arr = jnp.repeat(bts, 2, total_repeat_length=total)
        pos = lax.broadcasted_iota(jnp.int32, (total,), 0)
        syms = (arr >> ((pos & 1) * 4)) & 0xF
    else:
        syms = sl.reshape(-1).astype(jnp.int32) & 0xFF
    off = a - (r0 << 8)
    return syms[off : off + (b - a)]


def _device_window(ctx: _Ctx, s: int, W: int) -> np.ndarray:
    """Circular window text[s : s+W] as int32, sliced from the device
    text rows (no host gather/upload per block)."""
    import jax.numpy as jnp
    n = ctx.n
    s = s % n
    if s + W <= n:
        return _rows_slice_symbols(ctx, s, s + W)
    parts = [_rows_slice_symbols(ctx, s, n)]
    need = W - (n - s)
    while need > 0:
        take = min(need, n)
        parts.append(_rows_slice_symbols(ctx, 0, take))
        need -= take
    return jnp.concatenate(parts)


def _region_derive_fn():
    import jax
    import jax.numpy as jnp
    from jax import lax
    from ..ops.idx64 import take2d_u32
    from ..ops.pack import pack_bits_device

    @functools.partial(jax.jit, static_argnums=(7, 8))
    def fn(text_rows, sa_local, s_hi, s_lo, nm1_hi, nm1_lo, first,
           rate: int, bits: int):
        """Device-side region pieces from a block's local rotation order:
        (packed BWT bytes, sample local ranks [nsamp_max], r_start).
        Only ~0.5-1 byte/symbol reaches the host; s and n are traced so
        all equal-size blocks share one compile.  Positions are carried
        as (hi, lo) uint32 pairs — texts past 2^32 symbols exceed a
        single word — and the text gather is a 2-index (row, col)
        raw-u32 gather from the 2-D rows with row = hi * 2^24 | lo >> 8
        (a flat int32 take silently corrupts every block past position
        2^31)."""
        block_len = sa_local.shape[0]
        sa = sa_local.astype(jnp.uint32)
        pos_lo = s_lo + sa                          # in [s, e) subset [0, n)
        pos_hi = s_hi + (pos_lo < s_lo).astype(jnp.uint32)
        at_zero = jnp.logical_and(pos_lo == jnp.uint32(0),
                                  pos_hi == jnp.uint32(0))
        # idx = (pos - 1) mod n
        idx_lo = jnp.where(at_zero, nm1_lo, pos_lo - jnp.uint32(1))
        idx_hi = jnp.where(
            at_zero, nm1_hi,
            pos_hi - (pos_lo == jnp.uint32(0)).astype(jnp.uint32))
        row = (idx_hi << jnp.uint32(24)) | (idx_lo >> jnp.uint32(8))
        col = idx_lo & jnp.uint32(255)
        if bits == 4:
            byte = take2d_u32(text_rows, row, col >> jnp.uint32(1)).astype(
                jnp.int32) & 0xFF
            bwt = (byte >> ((col & jnp.uint32(1)) * 4).astype(jnp.int32)) & 0xF
        else:
            bwt = take2d_u32(text_rows, row, col).astype(jnp.int32) & 0xFF
        pad = (-block_len) % (8 // bits)
        bwt_p = jnp.concatenate(
            [bwt, jnp.zeros((pad,), bwt.dtype)]) if pad else bwt
        packed = pack_bits_device(bwt_p & 0xFF, bits)
        inv = jnp.zeros(block_len, jnp.int32).at[sa_local].set(
            lax.broadcasted_iota(jnp.int32, (block_len,), 0))
        nsamp_max = block_len // rate + 1
        sidx = (first.astype(jnp.int32) +
                rate * lax.broadcasted_iota(jnp.int32, (nsamp_max,), 0))
        samp = jnp.take(inv, jnp.minimum(sidx, block_len - 1))
        # r_start rides in the same array as the samples: ONE host fetch
        # per block instead of two
        return packed, jnp.concatenate([samp, inv[:1]])

    return fn


_region_derive = None


def _resolve_tie_groups(ctx: _Ctx, s: int, e: int, lo_order, hi_order):
    """Order the window-sort's residual prefix-tie groups by the rotation-e
    reduction, without growing the window (a lookahead-extension loop
    would silently lose the memory bound on periodic texts).

    For p < q in the block tying through the block end, rot_p vs rot_q
    reduces to cmp(rot_{e-(q-p)}, rot_e) — the gt-bitvector role (SURVEY.md
    hard-part 3). A maximal tie group's members make text[p_min..e)
    periodic in every pairwise gap, so prepending one more period preserves
    rotation order: an arithmetic-gap group is fully ordered by ONE
    comparator call on its smallest gap; non-arithmetic groups (exotic)
    fall back to a comparator sort over their distinct gaps. Equal
    rotations (cmp == 0) order by position, matching pad-high semantics."""
    import jax.numpy as jnp
    from .. import native

    n = ctx.n
    lo_np = np.asarray(lo_order, np.int64)
    hi_np = np.asarray(hi_order, np.int64)
    mism = lo_np != hi_np
    sa = hi_np.copy()
    idx = np.flatnonzero(mism)
    # Tie components: a pair is undecided iff the lo and hi sorts disagree
    # on it (their paddings break ties in OPPOSITE directions). "Tie" is
    # not transitive (x may tie q but be window-decided against p), and a
    # reversal fixed point can leave a member at the SAME slot in both
    # sorts, so the component is recovered by interval closure over both
    # orders starting from each mismatch run; the comparator below then
    # consults the window for decided pairs and the rotation-e reduction
    # for tied ones.
    inv_lo = np.empty(len(lo_np), np.int64)
    inv_lo[lo_np] = np.arange(len(lo_np))
    inv_hi = np.empty(len(hi_np), np.int64)
    inv_hi[hi_np] = np.arange(len(hi_np))
    raw_runs = np.split(idx, np.flatnonzero(np.diff(idx) != 1) + 1)
    runs = []
    last_end = -1
    for run in raw_runs:
        if len(run) == 0 or run[-1] <= last_end:
            continue
        i0, i1 = int(run[0]), int(run[-1])
        while True:
            ls = inv_lo[hi_np[i0 : i1 + 1]]
            hs = inv_hi[lo_np[i0 : i1 + 1]]
            ni0 = min(i0, int(ls.min()), int(hs.min()))
            ni1 = max(i1, int(ls.max()), int(hs.max()))
            if (ni0, ni1) == (i0, i1):
                break
            i0, i1 = ni0, ni1
        runs.append(np.arange(i0, i1 + 1))
        last_end = i1

    def cmp_e(gaps: np.ndarray) -> np.ndarray:
        xs = (e - gaps).astype(np.int64)
        out = native.cmp_rot(ctx.text, n, e % n, xs, ctx.nthreads)
        if out is not None:
            return out
        # numpy fallback (no native toolchain): direct rotation compares
        out = np.zeros(len(xs), np.int8)
        te = np.roll(ctx.text, -(e % n))
        for j, x in enumerate(xs):
            tx = np.roll(ctx.text, -int(x))
            neq = np.flatnonzero(tx != te)
            if len(neq):
                out[j] = 1 if tx[neq[0]] > te[neq[0]] else -1
        return out

    import functools as _ft

    for run in runs:
        if len(run) < 2:
            continue
        hi_run = sa[run]
        lo_run = lo_np[run]
        pure_tie = np.array_equal(lo_run, hi_run[::-1])
        pos = np.sort(hi_run)
        gaps = np.diff(pos)
        if pure_tie and (gaps == gaps[0]).all():
            # every pair tied; common period = the gap: one comparator
            # call orders the whole group (prepending one period to both
            # rotations preserves their order)
            f = int(cmp_e(np.array([gaps[0]]))[0])
            ordered = pos if f <= 0 else pos[::-1]
        else:
            if len(pos) > 4096:
                return None  # caller escapes by extending the window
            hi_slot = {int(p): i for i, p in enumerate(hi_run)}
            lo_slot = {int(p): i for i, p in enumerate(lo_run)}
            dg = np.unique(
                (pos[None, :] - pos[:, None])[np.triu_indices(len(pos), 1)])
            fmap = dict(zip(dg.tolist(), cmp_e(dg).tolist()))

            def c(a, b):
                if a == b:
                    return 0
                h = -1 if hi_slot[a] < hi_slot[b] else 1
                lo = -1 if lo_slot[a] < lo_slot[b] else 1
                if h == lo:
                    return h  # window-decided pair
                f = fmap[abs(b - a)]
                if f == 0:
                    return -1 if a < b else 1  # equal rotations: position
                return f if a < b else -f

            ordered = np.array(
                sorted(pos.tolist(), key=_ft.cmp_to_key(c)), dtype=np.int64)
        sa[run] = ordered
    return jnp.asarray(sa.astype(np.int32))


def _sort_block_scaled(ctx: _Ctx, s: int, e: int) -> _RegionS:
    """Rotation order of block [s, e) via windowed doubling (bounded
    lookahead), emitted as a scaled region (the full block SA lives only
    on device)."""
    import time as _time
    from ..ops.windowsort import block_suffix_order_device
    n = ctx.n
    block_len = e - s
    la_cap = min(max(1024, ctx.options.large_lcp_thres), n)
    la = min(1024, la_cap)
    _t0 = _time.time()
    while True:
        W = min(block_len + la, block_len + n)
        win = _device_window(ctx, s, W)
        lo_order, hi_order, resolved = block_suffix_order_device(
            win, block_len, ctx.sigma)
        if resolved:
            sa_local = lo_order
            break
        if la >= la_cap:
            # memory bound held: resolve residual ties by the rotation-e
            # reduction instead of growing the window towards n
            ctx.log.v("block [%d,%d): resolving ties via rotation "
                      "comparator at lookahead %d" % (s, e, la))
            sa_local = _resolve_tie_groups(ctx, s, e, lo_order, hi_order)
            if sa_local is not None:
                break
            if la >= n:
                sa_local = hi_order
                break
            # exotic giant mixed tie run: escape hatch — grow the window
            la_cap = n
        la = min(la * 4, la_cap)
        ctx.log.v("block [%d,%d): lookahead extended to %d" % (s, e, la))
    _t_sort = _time.time() - _t0
    disp = _derive_region_dispatch(ctx, s, e, sa_local)
    reg = _finish_region(ctx, s, e, disp)
    ctx.log.v("block [%d,%d): sort=%.2fs derive=%.2fs" %
              (s, e, _t_sort, _time.time() - _t0 - _t_sort))
    return reg


def _derive_region_dispatch(ctx: _Ctx, s: int, e: int, sa_local):
    """Dispatch the device tail of one block sort (region derive + row
    pack) without any sync; returns device handles."""
    global _region_derive
    if _region_derive is None:
        _region_derive = _region_derive_fn()
    import jax.numpy as jnp
    n = ctx.n
    packed, samp_r0 = _region_derive(
        ctx.text_rows, sa_local,
        jnp.uint32(s >> 32), jnp.uint32(s & 0xFFFFFFFF),
        jnp.uint32((n - 1) >> 32), jnp.uint32((n - 1) & 0xFFFFFFFF),
        jnp.uint32((-s) % ctx.rate),
        int(ctx.rate), int(ctx.bits))
    rows = None
    if ctx.device_tree:
        # the block's BWT was born on device — keep it there (the old
        # path downloaded it only to re-upload per merge level)
        from ..ops.devzip import rows_from_packed
        rows = rows_from_packed(packed, e - s, ctx.bits)
    return packed, samp_r0, rows


def _finish_region(ctx: _Ctx, s: int, e: int, disp) -> _RegionS:
    """Materialize a region from its dispatched device tail (one fetch
    for samples + r_start; the packed BWT only when the device tree is
    off)."""
    packed, samp_r0, rows = disp
    block_len = e - s
    bwt = None
    if not ctx.device_tree:
        pk = np.asarray(packed)
        if ctx.bits == 4:
            bwt = np.empty(len(pk) * 2, np.uint8)
            bwt[0::2] = pk & 0x0F
            bwt[1::2] = pk >> 4
            bwt = bwt[:block_len]
        else:
            bwt = pk[:block_len]
    first = (-s) % ctx.rate
    spos = np.arange(s + first, e, ctx.rate, dtype=np.int64)
    fetched = np.asarray(samp_r0, np.int64)
    sranks = fetched[: len(spos)]
    r0 = int(fetched[-1])
    from .. import native
    hist = native.byte_hist(ctx.text[s:e], minlength=ctx.sigma)[:ctx.sigma]
    return _RegionS(s, e, bwt, spos, sranks, r0, hist, rows=rows)


def _block_sort_fused_fn():
    import jax
    import jax.numpy as jnp
    from jax import lax
    from ..ops.windowsort import _block_filter, _window_order_body
    from ..ops.pack import pack_bits_device
    from ..ops.idx64 import take2d_u32
    from ..ops.devzip import _row_w
    from ..ops.focc import _pad_rows

    @functools.partial(jax.jit, static_argnums=(6, 7, 8, 9, 10))
    def fn(text_rows, s_hi, s_lo, nm1_hi, nm1_lo, first,
           W: int, block_len: int, sigma: int, rate: int, bits: int):
        """One block sort as ONE device program: window slice -> both
        padded window orders -> block filters -> mismatch count ->
        region derive -> packed region rows, in place of seven separate
        dispatches.  Requires s % 256 == 0 and s + W <= n (no wrap);
        the tail block takes the unfused path."""
        row0 = ((s_hi << jnp.uint32(24))
                | (s_lo >> jnp.uint32(8))).astype(jnp.int32)
        nrows_w = W // 256
        sl = lax.dynamic_slice_in_dim(text_rows, row0, nrows_w, axis=0)
        if bits == 4:
            bts = sl.reshape(-1).astype(jnp.int32) & 0xFF
            arr = jnp.repeat(bts, 2, total_repeat_length=W)
            pos = lax.broadcasted_iota(jnp.int32, (W,), 0)
            win = (arr >> ((pos & 1) * 4)) & 0xF
        else:
            win = sl.reshape(-1).astype(jnp.int32) & 0xFF
        # hi-pad confirmation sort runs only when the lo doubling's
        # fast-resolution flag is off (see _window_order_body): for
        # random text the block sort is ONE doubling sort, not two
        la = W - block_len
        lo_sa, fast = _window_order_body(win, sigma, False, la)
        lo_b = _block_filter(lo_sa, block_len, W)

        def _confirm(_):
            hi_sa = _window_order_body(win, sigma, True, 0)[0]
            hi_b = _block_filter(hi_sa, block_len, W)
            return jnp.sum((lo_b != hi_b).astype(jnp.int32))

        mism = lax.cond(fast, lambda _: jnp.int32(0), _confirm,
                        operand=None)

        # region derive (the _region_derive_fn body on lo_b)
        sa = lo_b.astype(jnp.uint32)
        pos_lo = s_lo + sa
        pos_hi = s_hi + (pos_lo < s_lo).astype(jnp.uint32)
        at_zero = jnp.logical_and(pos_lo == jnp.uint32(0),
                                  pos_hi == jnp.uint32(0))
        idx_lo = jnp.where(at_zero, nm1_lo, pos_lo - jnp.uint32(1))
        idx_hi = jnp.where(
            at_zero, nm1_hi,
            pos_hi - (pos_lo == jnp.uint32(0)).astype(jnp.uint32))
        row = (idx_hi << jnp.uint32(24)) | (idx_lo >> jnp.uint32(8))
        col = idx_lo & jnp.uint32(255)
        if bits == 4:
            byte = take2d_u32(text_rows, row, col >> jnp.uint32(1)).astype(
                jnp.int32) & 0xFF
            bwt = (byte >> ((col & jnp.uint32(1)) * 4).astype(
                jnp.int32)) & 0xF
        else:
            bwt = take2d_u32(text_rows, row, col).astype(jnp.int32) & 0xFF
        pad = (-block_len) % (8 // bits)
        bwt_p = jnp.concatenate(
            [bwt, jnp.zeros((pad,), bwt.dtype)]) if pad else bwt
        packed = pack_bits_device(bwt_p & 0xFF, bits)
        inv = jnp.zeros(block_len, jnp.int32).at[lo_b].set(
            lax.broadcasted_iota(jnp.int32, (block_len,), 0))
        nsamp_max = block_len // rate + 1
        sidx = (first.astype(jnp.int32) +
                rate * lax.broadcasted_iota(jnp.int32, (nsamp_max,), 0))
        samp = jnp.take(inv, jnp.minimum(sidx, block_len - 1))

        # region rows (rows_from_packed body)
        w = _row_w(bits)
        nrows = max(1, (block_len + 255) // 256)
        nrows_pad = _pad_rows(nrows)
        buf = jnp.zeros((nrows_pad, w), jnp.int8)
        p8 = lax.bitcast_convert_type(packed, jnp.int8)
        nbytes = nrows * w
        if p8.shape[0] < nbytes:
            p8 = jnp.concatenate(
                [p8, jnp.zeros(nbytes - p8.shape[0], jnp.int8)])
        rows = buf.at[:nrows].set(p8[:nbytes].reshape(nrows, w))
        # samples + r_start + mismatch count in ONE fetched array
        return rows, jnp.concatenate([samp, inv[:1], mism[None]])

    return fn


_block_sort_fused = None


def _sort_blocks_pipelined(ctx: _Ctx, blocks) -> List[_RegionS]:
    """Sort every block as ONE fused device program each, all dispatched
    before any fetch (async), then materialize in order.  A block whose
    window sort did not resolve at the base lookahead (mismatch count in
    the fetched tail) escalates to the per-block loop; blocks the fused
    kernel cannot take (window wraps past n, unaligned tail, device
    tree off) use the unfused path."""
    import time as _time
    import jax.numpy as jnp
    _t0 = _time.time()
    la = min(1024, min(max(1024, ctx.options.large_lcp_thres), ctx.n))
    global _block_sort_fused
    if _block_sort_fused is None:
        _block_sort_fused = _block_sort_fused_fn()
    n = ctx.n
    disp = {}
    for i, (s, e) in enumerate(blocks):
        W = (e - s) + la
        if (ctx.device_tree and s % 256 == 0 and W % 256 == 0
                and s + W <= n):
            disp[i] = _block_sort_fused(
                ctx.text_rows,
                jnp.uint32(s >> 32), jnp.uint32(s & 0xFFFFFFFF),
                jnp.uint32((n - 1) >> 32), jnp.uint32((n - 1) & 0xFFFFFFFF),
                jnp.uint32((-s) % ctx.rate),
                int(W), int(e - s), int(ctx.sigma), int(ctx.rate),
                int(ctx.bits))
    nfused = len(disp)
    regions: List[_RegionS] = []
    escal = 0
    from .. import native
    for i, (s, e) in enumerate(blocks):
        if i in disp:
            rows, tail = disp.pop(i)
            fetched = np.asarray(tail, np.int64)
            if fetched[-1]:          # window sort unresolved: escalate
                escal += 1
                regions.append(_sort_block_scaled(ctx, s, e))
                continue
            first = (-s) % ctx.rate
            spos = np.arange(s + first, e, ctx.rate, dtype=np.int64)
            hist = native.byte_hist(ctx.text[s:e],
                                    minlength=ctx.sigma)[:ctx.sigma]
            regions.append(_RegionS(
                s, e, None, spos, fetched[: len(spos)],
                int(fetched[-2]), hist, rows=rows))
        else:
            regions.append(_sort_block_scaled(ctx, s, e))
    ctx.log.v("block sorts: %d blocks (%d fused) in %.2fs (%d escalated)"
              % (len(blocks), nfused, _time.time() - _t0, escal))
    return regions


def _interleave_fallback(gap8, ov_idx, ov_val, left, right):
    gap = gap8.astype(np.int64)
    gap[ov_idx] = ov_val
    out = np.empty(len(left) + len(right), np.uint8)
    cnt_le = np.cumsum(gap)
    M = len(right)
    out[np.arange(M) + cnt_le[:M]] = right
    out[np.repeat(np.arange(M + 1), gap) + np.arange(len(left))] = left
    return out


def _merge_pair_scaled(ctx: _Ctx, left: _RegionS, right: _RegionS,
                       anchor_lookback: int = 64) -> _RegionS:
    import time as _time
    from .. import native
    s, m, e = left.s, left.e, right.e
    assert right.s == m
    block_len = m - s
    log = ctx.log
    _t = _time.time()
    _ph = {}

    def _mark(name):
        nonlocal _t
        now = _time.time()
        _ph[name] = _ph.get(name, 0.0) + (now - _t)
        _t = now

    # chunked host->device build: O(chunk) transients (the monolithic
    # builder's 4 B/symbol int32 staging would exceed HBM at Gbp-scale
    # root merges) and no flat device array.  Merges whose rank space or
    # left block exceed uint32 (texts past 2^33) take the two-word
    # chain kernels (ops/gapwide.py)
    wide = (e - m + 2 > ((1 << 24) - 1) * 256 or m - s >= (1 << 32)
            or bool(os.environ.get("BWTB3M_FORCE_WIDE")))
    if wide:
        from ..ops.gapwide import WideDeviceGapRunner, widen_focc
        if ctx.device_tree:
            # wide merges stay device-resident too, instead of falling
            # back to the host zip/fetch route
            from ..ops.focc_build import build_focc_from_rows
            focc, bases, g = build_focc_from_rows(
                _region_rows(ctx, right), e - m, ctx.sigma,
                return_bases=True)
            wocc = widen_focc(focc, bases, g, e - m)
        else:
            rbwt = _region_bwt(ctx, right)
            focc, bases, g = build_focc_host(rbwt, ctx.sigma,
                                             return_bases=True)
            wocc = widen_focc(focc, bases, g, len(rbwt))
        _mark("focc")
        runner = WideDeviceGapRunner(
            wocc, ctx.text_rows, ctx.text, s, m, e,
            isa_m=right.r_start, first_hist=right.hist,
            lane_bucket=ctx.lane_bucket, sample_rate=ctx.rate,
            nthreads=ctx.nthreads, log=log)
    else:
        if ctx.device_tree:
            from ..ops.focc_build import build_focc_from_rows
            focc = build_focc_from_rows(_region_rows(ctx, right),
                                        e - m, ctx.sigma)
        else:
            focc = build_focc_host(right.bwt, ctx.sigma)
        _mark("focc")
        runner = DeviceGapRunner(
            focc, ctx.text_rows, ctx.text, s, m, e,
            isa_m=right.r_start, first_hist=right.hist,
            lane_bucket=ctx.lane_bucket, sample_rate=ctx.rate,
            nthreads=ctx.nthreads, log=log)
    exec_ = runner
    if ctx.mesh is not None and not wide and \
            _mesh_wants_occ_sharding(ctx, runner):
        # rank rows + gap histogram sharded by rank range over the mesh:
        # one pair merge's right region may exceed a single device's HBM
        # (parallel/shocc.py; the lane-sharded path below is the
        # compute-scaling alternative when the region fits one device)
        from ..parallel.shocc import ShardedOccGapRunner
        exec_ = ShardedOccGapRunner(ctx.mesh, runner)
    _mark("init")

    # segment plan: T lanes over [s, m)
    T = max(1, min(ctx.lane_bucket, block_len // 64 or 1))
    bounds = np.linspace(s, m, T + 1).astype(np.int64)
    starts = bounds[1:] - 1
    lens = np.diff(bounds)
    seeds = np.zeros(T, dtype=np.int64)
    seeds[T - 1] = right.r_start
    if T > 1:
        lb = anchor_lookback
        todo = np.arange(T - 1)
        while len(todo):
            vals, ok = exec_.anchor(starts[todo], min(lb, ctx.n))
            seeds[todo[ok]] = vals[ok]
            todo = todo[~ok]
            if len(todo) and lb >= ctx.n:
                raise AssertionError(
                    "anchor unresolved at full lookback — equal-rotation "
                    "boundary should be impossible for interior anchors")
            lb = min(lb * 4, ctx.n)
            if len(todo):
                log.v("anchor lookback extended to %d for %d lanes"
                      % (lb, len(todo)))
    _mark("anchor")

    plan = None
    if exec_ is not runner:
        # occ-sharded path: same u16-wrap escape as single-device (the
        # local histograms are u16 too)
        exec_.run_chains(starts, seeds, lens)
        total = runner.gap_checksum()
        if total != block_len:
            log.v("gap u16 checksum %d != %d: rerunning sharded chains "
                  "with int32 histogram" % (total, block_len))
            exec_.run_chains(starts, seeds, lens, force_int32=True)
            total = runner.gap_checksum()
    elif ctx.mesh is not None:
        # multi-chip intra-pair path: chain lanes sharded over the mesh
        # (rank rows replicated, per-device partial histograms, one
        # reduction at the end); runner state mirrors the single-device
        # run so everything downstream is unchanged
        from ..parallel.merge import ShardedGapRunner
        ShardedGapRunner(ctx.mesh, runner).run_chains(starts, seeds, lens)
        total = runner.gap_checksum()
    else:
        runner.run_chains(starts, seeds, lens)
        if ctx.device_tree and not wide:
            # fused tail plan: checksum + zip chunk starts + right-side
            # sample counts in ONE dispatch + ONE fetch (devzip.zip_plan)
            plan = _plan_finish(ctx, left, right, runner)
            total = plan[0]
        else:
            total = runner.gap_checksum()
        if total != block_len:
            # a u16 histogram cell wrapped (>= 2^16 left suffixes between
            # one right pair — extremely repetitive input): rerun the
            # chains with the int32 histogram; wraps only lower the sum,
            # so a clean checksum certifies the u16 result
            log.v("gap u16 checksum %d != %d: rerunning chains with "
                  "int32 histogram" % (total, block_len))
            runner.run_chains(starts, seeds, lens, force_int32=True)
            if plan is not None:
                plan = _plan_finish(ctx, left, right, runner)
                total = plan[0]
            else:
                total = runner.gap_checksum()
    _mark("chains")
    assert total == block_len, (total, block_len)
    # chain self-check: every lane's final R(bounds[j]) must equal the
    # anchor-provided seed of the lane to its left (exact because resolved
    # contraction brackets the true rank) — the rebuild's analog of the
    # reference's pervasive stream assertions (SURVEY.md section 4.4)
    if T > 1:
        if not np.array_equal(runner.final_rs[1:], seeds[:-1]):
            bad = int(np.flatnonzero(runner.final_rs[1:] != seeds[:-1])[0])
            raise AssertionError(
                "anchor/chain mismatch at lane %d: %d != %d"
                % (bad + 1, runner.final_rs[bad + 1], seeds[bad]))

    if ctx.device_tree and exec_ is runner:
        if wide:
            out = _finish_merge_dev_wide(ctx, left, right, runner,
                                         runner.gap, _mark=_mark)
        else:
            out = _finish_merge_dev(ctx, left, right, runner, runner.gap,
                                    plan=plan, _mark=_mark)
        runner.gap = None
    else:
        gap8, ov_idx, ov_val = runner.fetch_gap_compressed()
        _mark("gapfetch")
        out = _finish_merge(ctx, left, right, runner, gap8, ov_idx,
                            ov_val, _mark)
    log.v("merge [%d,%d,%d): " % (s, m, e) + " ".join(
        "%s=%.2fs" % kv for kv in sorted(_ph.items(), key=lambda x: -x[1])))
    return out


def _plan_finish(ctx: _Ctx, left: _RegionS, right: _RegionS, runner):
    """Fused merge-tail plan (ops/devzip.zip_plan): ONE dispatch + ONE
    fetch for the checksum, the zip chunk starts, and the right-side
    sample counts.  Returns (total, row_cum, r_starts, cnt_le)."""
    from ..ops import devzip
    gap = runner.gap
    row_cum = devzip.gap_row_cum_excl(gap)
    A = left.e - left.s
    B = right.e - right.s
    total_out = A + B
    CH = devzip._chunk_size(total_out)
    ts = np.arange((total_out + CH - 1) // CH, dtype=np.int64) * CH
    total, r_starts, cnt_le = devzip.zip_plan(gap, row_cum, B, ts,
                                             right.samp_rank)
    return total, row_cum, r_starts, cnt_le


def _finish_merge_dev(ctx: _Ctx, left: _RegionS, right: _RegionS, runner,
                      gap, row0: int = 0, cum_base=None, row_cum=None,
                      plan=None, _mark=lambda name: None) -> _RegionS:
    """Device tail of one pair merge: gap-guided interleave of the two
    regions' device rows (ops/devzip.py) and sample updates served by
    batched row gathers over the DEVICE histogram — no gap download, no
    host zip, no re-upload at the next level.  ``row0``/``cum_base``
    address one merge's span of a level-global histogram (batched
    levels); ``plan`` carries the fused zip_plan results (per-pair
    path) so the tail costs no extra round trips."""
    from ..ops import devzip
    r_starts = cnt_le = None
    if plan is not None:
        _total, row_cum, r_starts, cnt_le = plan
    if row_cum is None:
        row_cum = devzip.gap_row_cum_excl(gap)
    A = left.e - left.s
    B = right.e - right.s
    merged_rows = devzip.device_interleave(
        _region_rows(ctx, left), A, _region_rows(ctx, right), B, gap,
        row_cum, ctx.bits, row0=row0, cum_base=cum_base,
        r_starts=r_starts)
    _mark("zip")

    hpos, hval = runner.harvest_samples()
    if not np.array_equal(hpos, left.samp_pos):
        raise AssertionError(
            "chain sample harvest mismatch: %d vs %d positions"
            % (len(hpos), len(left.samp_pos)))
    new_left_rank = left.samp_rank + hval
    if cnt_le is None:
        cnt_le = devzip.cnt_le_at_ranks(
            gap, row_cum, right.samp_rank, row0=row0, cum_base=cum_base)
    new_right_rank = right.samp_rank + cnt_le
    # left positions all < m <= right positions; both ascending
    pos = np.concatenate([left.samp_pos, right.samp_pos])
    rank = np.concatenate([new_left_rank, new_right_rank])
    r_start = int(left.r_start + runner.final_rs[0])
    _mark("samples")
    return _RegionS(left.s, right.e, None, pos, rank, r_start,
                    left.hist + right.hist, rows=merged_rows)


def _finish_merge_dev_wide(ctx: _Ctx, left: _RegionS, right: _RegionS,
                           runner, gap,
                           _mark=lambda name: None) -> _RegionS:
    """Wide device tail: same structure as _finish_merge_dev with the
    (hi, lo) pair kernels (ops/devzip.py wide variants) — merges whose
    rank space exceeds uint32 stay device-resident instead of falling
    back to the host zip/fetch route."""
    from ..ops import devzip
    row_cum = devzip.gap_row_cum_excl_w(gap)
    A = left.e - left.s
    B = right.e - right.s
    merged_rows = devzip.device_interleave_w(
        _region_rows(ctx, left), A, _region_rows(ctx, right), B, gap,
        row_cum, ctx.bits)
    _mark("zip")

    hpos, hval = runner.harvest_samples()
    if not np.array_equal(hpos, left.samp_pos):
        raise AssertionError(
            "chain sample harvest mismatch: %d vs %d positions"
            % (len(hpos), len(left.samp_pos)))
    new_left_rank = left.samp_rank + hval
    new_right_rank = right.samp_rank + devzip.cnt_le_at_ranks_w(
        gap, row_cum, right.samp_rank)
    pos = np.concatenate([left.samp_pos, right.samp_pos])
    rank = np.concatenate([new_left_rank, new_right_rank])
    r_start = int(left.r_start + runner.final_rs[0])
    _mark("samples")
    return _RegionS(left.s, right.e, None, pos, rank, r_start,
                    left.hist + right.hist, rows=merged_rows)


def _finish_merge(ctx: _Ctx, left: _RegionS, right: _RegionS, runner,
                  gap8, ov_idx, ov_val,
                  _mark=lambda name: None) -> _RegionS:
    """Host tail of one pair merge from its fetched gap: zip the two BWTs
    and update the preisa samples.  ``runner`` is a DeviceGapRunner or a
    BatchedGapRunner view — both expose final_rs / harvest_samples /
    cnt_le_at_host."""
    from .. import native
    lbwt = _region_bwt(ctx, left)
    rbwt = _region_bwt(ctx, right)
    merged = native.gap_interleave(gap8, ov_idx, ov_val, lbwt, rbwt)
    if merged is None:
        merged = _interleave_fallback(gap8, ov_idx, ov_val, lbwt, rbwt)
    _mark("zip")

    # sample updates
    hpos, hval = runner.harvest_samples()
    if not np.array_equal(hpos, left.samp_pos):
        raise AssertionError(
            "chain sample harvest mismatch: %d vs %d positions"
            % (len(hpos), len(left.samp_pos)))
    new_left_rank = left.samp_rank + hval
    new_right_rank = right.samp_rank + runner.cnt_le_at_host(
        right.samp_rank, gap8, ov_idx, ov_val)
    pos = np.concatenate([left.samp_pos, right.samp_pos])
    rank = np.concatenate([new_left_rank, new_right_rank])
    order = np.argsort(pos)
    r_start = int(left.r_start + runner.final_rs[0])
    _mark("samples")
    return _RegionS(left.s, right.e, merged, pos[order], rank[order],
                    r_start, left.hist + right.hist)


def _mesh_wants_occ_sharding(ctx: _Ctx, runner) -> bool:
    """Auto-dispatch of the distributed per-merge state: under a mesh,
    choose rank-range-sharded occ
    rows (memory scaling) over lane-sharded chains (compute scaling) by
    per-device HBM arithmetic — the lane path replicates the right
    region's rank rows and a per-device int32 histogram partial on every
    device.  ``BWTB3M_SHARD_OCC=1/0`` still forces either way."""
    env = os.environ.get("BWTB3M_SHARD_OCC")
    if env is not None:
        return env != "0"
    budget = device_budget("BWTB3M_DEV_HBM", ctx.mesh.devices.flat[0])
    rows_b = int(runner.focc.rows.size)
    from ..ops.gapdev import _pad_pow2
    gap_b = _pad_pow2((runner.gap_size + 2 + 255) // 256, lo=4) * 256 * 4
    text_b = int(ctx.text_rows.size)
    return rows_b + gap_b + text_b > budget


def _level_fits_batched(ctx: _Ctx, pairs) -> bool:
    """Gate for the batched-level path: combined device state (concat
    rank rows + u16 histogram + full-span gt) must fit alongside the
    engine-wide text rows, the level rank space must stay uint32, and
    the row space must leave the scatter sentinel out of range."""
    from ..ops.gapbatch import concat_bytes_estimate
    right_lens = [r.e - r.s for _l, r in pairs]
    left_total = sum(l.e - l.s for l, _r in pairs)
    total_rows = sum((ln + 255) // 256 + 1 for ln in right_lens)
    if total_rows + 2 > (1 << 24) - 1:
        return False
    # explicit wide-merge guard: any pair that would
    # dispatch the two-word runner in _merge_pair_scaled must not enter
    # the narrow batched kernels — do not rely on the row-count bound
    # above coinciding with the uint32 envelope
    for l, r in pairs:
        if (r.e - r.s + 2 > ((1 << 24) - 1) * 256 or l.e - l.s >= (1 << 32)
                or os.environ.get("BWTB3M_FORCE_WIDE")):
            return False
    budget = device_budget(
        "BWTB3M_BATCH_HBM",
        None if ctx.mesh is None else ctx.mesh.devices.flat[0])
    text_b = ctx.text_rows.size if hasattr(ctx.text_rows, "size") else 0
    extra = 0
    if ctx.device_tree:
        # device-resident regions: current-level rows + accumulating
        # merged-output rows, both packed at ctx.bits
        extra = (left_total + sum(right_lens)) * 2 * ctx.bits // 8
    return concat_bytes_estimate(right_lens, left_total, ctx.sigma) \
        <= budget - int(text_b) - extra


def _merge_level_batched(ctx: _Ctx, level, stop_file: str, done: int,
                         total: int):
    """All pair merges of one tree level in shared device dispatches
    (ops/gapbatch.py); an odd trailing region is carried unchanged.
    Falls back to the per-pair path for a merge whose u16 histogram
    wrapped (checksum certifies the batch result otherwise)."""
    import time as _time
    from ..ops.gapbatch import BatchedGapRunner
    if os.path.exists(stop_file):
        raise RuntimeError("stop requested via %s after %d/%d merges"
                           % (stop_file, done, total))
    pairs = [(level[i], level[i + 1]) for i in range(0, len(level) - 1, 2)]
    carried = [level[-1]] if len(level) % 2 else []
    t0 = _time.time()
    devtree = ctx.device_tree
    runner = BatchedGapRunner(
        ctx.text_rows, ctx.text, ctx.sigma,
        [(l.s, l.e, r.e, None if devtree else _region_bwt(ctx, r),
          r.r_start, r.hist) for l, r in pairs],
        lane_bucket=ctx.lane_bucket, sample_rate=ctx.rate,
        nthreads=ctx.nthreads, log=ctx.log,
        right_rows=[_region_rows(ctx, r) for _l, r in pairs]
        if devtree else None, mesh=ctx.mesh)
    runner.compute([r.r_start for _l, r in pairs], fetch_host=not devtree)
    ctx.log.v("batched level: %d merges, device phases %.2fs"
              % (len(pairs), _time.time() - t0))
    row_cum = None
    handles = {}
    if devtree:
        from ..ops import devzip
        from ..ops.devzip import gap_row_cum_excl
        row_cum = gap_row_cum_excl(runner.gap)
        # dispatch EVERY pair's fused tail plan before fetching any (and
        # before any zip dispatch): on the device's in-order stream a
        # plan fetched after another pair's zip would wait for that
        # zip's execution
        for k, (l, r) in enumerate(pairs):
            if runner.checksum(k) != l.e - l.s:
                continue
            sp = runner.specs[k]
            B = r.e - r.s
            total_out = (l.e - l.s) + B
            CH = devzip._chunk_size(total_out)
            ts = np.arange((total_out + CH - 1) // CH, dtype=np.int64) * CH
            row0 = sp.rbase // 256
            handles[k] = devzip.zip_plan_dispatch(
                runner.gap, row_cum, B, ts, r.samp_rank,
                row0=row0, cum_base=row_cum[row0])
    nxt: List[_RegionS] = []
    for k, (l, r) in enumerate(pairs):
        if runner.checksum(k) != l.e - l.s:
            # u16 cell wrapped for this merge (extremely repetitive
            # input): redo just this pair through the per-pair path,
            # which reruns its chains with the int32 histogram
            ctx.log.v("batched merge %d checksum mismatch: per-pair "
                      "int32 rerun" % k)
            nxt.append(_merge_pair_scaled(ctx, l, r))
        elif devtree:
            from ..ops import devzip
            sp = runner.specs[k]
            row0 = sp.rbase // 256
            # plan total is the LEVEL-global histogram sum; the per-pair
            # checksum above (host _row_sums) is the correctness gate
            _gtotal, r_starts, cnt_le = devzip.zip_plan_fetch(handles[k])
            nxt.append(_finish_merge_dev(
                ctx, l, r, runner.view(k), runner.gap, row0=row0,
                cum_base=row_cum[row0], row_cum=row_cum,
                plan=(None, row_cum, r_starts, cnt_le)))
        else:
            view = runner.view(k)
            gap8, ov_idx, ov_val = view.fetch_gap_compressed()
            nxt.append(_finish_merge(ctx, l, r, view, gap8, ov_idx,
                                     ov_val))
        done += 1
        ctx.log.v("merged [%d,%d): %d/%d" % (nxt[-1].s, nxt[-1].e,
                                             done, total))
    runner.gap = None
    return nxt + carried, done


def _validate_scale(n: int) -> None:
    """Reject lengths past the engine's exact-arithmetic envelope.

    The balanced tree keeps every per-merge rank space < 2^32 for
    n < 2^33, so uint32 chain lanes stay exact there; merges past that
    dispatch the two-word runner (ops/gapwide.py — rank rows addressed
    by int32 block row, exact to 2^39).  The binding limit is the wide
    rank structure's wrap tracking: THR_K = 8 recorded occ-lo wraps per
    symbol (ops/wideocc.py), exact to n = 2^35."""
    if n >= (1 << 35):
        raise ValueError(
            "texts >= 2^35 symbols exceed the wide rank structure's "
            "THR_K wrap tracking (ops/wideocc.py)")


def blockwise_bwt_scaled(
    symbols: np.ndarray, sigma: int, options: BwtOptions,
    log: Optional[VerboseLog] = None, sample_rate: int = 1024,
    lane_bucket: int = 1 << 16, mesh=None, rows_out: Optional[list] = None,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Returns (bwt uint8, preisa positions, preisa ranks, symbol hist) —
    the bwtonly output set (reference: .bwt/.hist/.preisa, README
    "Output"); SA/ISA derive from these via engine/ssa.py exactly as
    bwtcomputessa does.

    ``rows_out``: optional empty list; when the build ends with the
    final region device-resident and bit-plane-eligible, a
    ``DeviceRowsHandle`` is appended so the caller can register the rows
    against the ``.bwt`` it is about to write (no module-global state)."""
    log = log or VerboseLog(1)
    text = np.asarray(symbols)
    n = len(text)
    if sigma > 256:
        raise ValueError("scaled merge engine supports sigma <= 256 "
                         "(byte device text); rank-compact the alphabet "
                         "first (engine/api.py does for utf-8)")
    _validate_scale(n)
    ctx = _Ctx(text, sigma, sample_rate, options, log, lane_bucket,
               mesh=mesh)
    blocks = _plan_blocks_fixed(n, options.max_block_symbols)
    log.v("scaled blockwise engine: %d blocks, rate=%d, lanes<=%d"
          % (len(blocks), sample_rate, lane_bucket))

    # durable merge-tree checkpointing: resume from the deepest
    # complete saved tree nodes (reference: tmpprefix durability,
    # /root/reference/src/bwtb3m.cpp:52-53, checkbwt.cpp:24)
    ckpt = None
    avail = {}
    if (getattr(options, "checkpoint", False) and options.tmp_prefix
            and len(blocks) > 1):
        from .checkpoint import MergeCheckpointer, build_key
        key = build_key(ctx.text, sigma, sample_rate,
                        blocks[0][1] - blocks[0][0])
        ctx._ckpt_key = key
        ckpt = MergeCheckpointer(
            options.tmp_prefix, key, ctx.bits,
            min_symbols=getattr(options, "checkpoint_min_symbols",
                                1 << 26), log=log)
        avail = ckpt.scan()
        if avail:
            log.v("checkpoint resume: %d saved regions under %s"
                  % (len(avail), options.tmp_prefix))
            ckpt.adopt(avail)

    def _covered(s, e):
        return any(a <= s and e <= b for a, b in avail)

    if not avail and len(blocks) > 1:
        # fresh build: overlap every block's device sort with the
        # other blocks' host round trips (async dispatch)
        regions: List[object] = list(
            _sort_blocks_pipelined(ctx, blocks))
    else:
        regions = []
        for s, e in blocks:
            if (s, e) in avail:
                regions.append(_load_saved(ctx, avail, s, e))
            elif _covered(s, e):
                regions.append(_Hole(s, e))
            else:
                regions.append(_sort_block_scaled(ctx, s, e))

    stop_file = options.output_filename + ".stop"
    total = len(regions) - 1
    done = 0
    level = regions
    ok = False
    try:
        while len(level) > 1:
            pairs = [(level[i], level[i + 1])
                     for i in range(0, len(level) - 1, 2)]
            resuming = bool(avail) and (
                any(isinstance(r, _Hole) for r in level)
                or any((l.s, r.e) in avail for l, r in pairs))
            # batched levels run under a mesh too: the lane axis
            # shards over devices, assigning whole pair merges to
            # device groups (parallel/merge.py batched-level fns)
            mesh_ok = (ctx.mesh is None
                       or ctx.lane_bucket % int(
                           ctx.mesh.devices.size) == 0)
            if (len(pairs) >= 2 and mesh_ok
                    and not resuming
                    and getattr(options, "batch_merges", True)
                    and _level_fits_batched(ctx, pairs)):
                level, done = _merge_level_batched(
                    ctx, level, stop_file, done, total)
            else:
                nxt: List[object] = []
                i = 0
                while i + 1 < len(level):
                    if os.path.exists(stop_file):
                        raise RuntimeError(
                            "stop requested via %s after %d/%d merges"
                            % (stop_file, done, total))
                    l, r = level[i], level[i + 1]
                    span = (l.s, r.e)
                    if span in avail:
                        merged = _load_saved(ctx, avail, *span)
                        log.v("resumed merge [%d,%d) from checkpoint"
                              % span)
                    elif isinstance(l, _Hole) or isinstance(r, _Hole):
                        if not _covered(*span):
                            raise RuntimeError(
                                "inconsistent checkpoint state at "
                                "[%d,%d): clear %s_BWTREG1_reg_*"
                                % (span[0], span[1],
                                   options.tmp_prefix))
                        merged = _Hole(*span)
                    else:
                        merged = _merge_pair_scaled(ctx, l, r)
                        if ckpt is not None:
                            # per completed merge, not per level: a
                            # crash mid-level resumes at the last
                            # finished pair
                            ckpt.offer(merged, _bwt_getter(ctx, merged))
                    done += 1
                    log.v("merged [%d,%d): %d/%d"
                          % (merged.s, merged.e, done, total))
                    nxt.append(merged)
                    i += 2
                if i < len(level):
                    nxt.append(level[i])
                level = nxt
            if ckpt is not None:
                # force + drain ahead of the root merge: its children
                # persist before the longest merge starts, so resume
                # is never more than one level behind
                root_next = len(level) == 2
                for reg in level:
                    if not isinstance(reg, _Hole):
                        ckpt.offer(reg, _bwt_getter(ctx, reg),
                                   force=root_next)
                if root_next:
                    ckpt.drain()
        final = level[0]
        assert not isinstance(final, _Hole)
        bwt = _region_bwt(ctx, final)  # one packed download per build
        # hand the final device rows to the result layer: an
        # in-process checkbwt/ssa builds its rank structure from HBM
        # instead of re-uploading the .bwt (engine/result.py).  Only
        # when the host build would not dense-remap (all symbols
        # present, bitplane-eligible sigma).
        if (rows_out is not None and ctx.device_tree and sigma <= 8
                and final.rows is not None
                and bool((final.hist > 0).all())):
            rows_out.append(DeviceRowsHandle(
                final.rows, n, sigma,
                np.asarray(final.hist, np.int64).copy()))
        final.rows = None
        ok = True
    finally:
        if ckpt is not None:
            ckpt.finish(ok)
    return bwt, final.samp_pos, final.samp_rank, final.hist

"""Two-word (hi, lo) gap chains — pair merges whose rank space exceeds
uint32, i.e. texts past 2^33 symbols.

The scaled merge engine's chain lanes carry uint32 ranks (ops/gapdev.py):
exact while every per-merge right region stays below 2^32 rotations,
which the balanced tree guarantees for n < 2^33.  The reference has no
such ceiling (64-bit end-to-end, /root/reference/src/lcpbit.cpp:552-557),
so past 2^33 the chains themselves go two-word, reusing the wide rank
machinery the whole-text walk kernels already have (ops/wideocc.py):

- rank queries through ``rank_batch_w`` (derived hi word from the wrap
  threshold table — the row gather stays ONE 128/384-byte row);
- lane ranks, the c_first table and the isa_m constant travel as
  (hi, lo) uint32 pairs with explicit carry/borrow on every step
  (all non-checkpoint addends are 0/1 or < 2^32);
- the gap histogram keeps its 2-D [rows, 256] layout — the scatter row
  (hi << 24 | lo >> 8) is int32-exact to 2^39 ranks, so only the ROW
  COUNT grows (u16 cells; the same checksum-certified wrap escape).

Per-merge device state at the 2^33 root merge: ~2 GB bit-plane rank rows
+ 8.6 GB u16 histogram; where that exceeds a device, the rank-range
sharded executor (parallel/shocc.py) splits it; this module provides the
exact arithmetic, dispatched per merge by engine/merge_scaled.py.

Tested by forcing the wide runner on small merges (bit-identity vs the
narrow runner) plus doctored structures whose ranks straddle 2^32
(tests/test_gapwide.py) — a real 8.6 G-symbol build cannot run here.
"""

from __future__ import annotations

from functools import partial
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from .gapdev import (TEXT_BLOCK, DeviceGapRunner, _col_read, _pad_pow2,
                     _read_tg, _select_small, chunk_outer)
from .wideocc import WideOcc, rank_batch_w, widen_focc  # noqa: F401

# scatter sentinel: a positive row no legal histogram reaches (rows are
# int32 < 2^31; negative values would WRAP before mode="drop" applies)
_SENT_ROW = jnp.int32(0x7FFFFFFF)


def _chain_step_w(w: WideOcc, cf_hi, cf_lo, consts_hi, consts_lo,
                  r_hi, r_lo, c, g0, active
                  ) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """ops/gapdev._chain_step with (hi, lo) rank words.

    r_new = c_first[c] + rank(c, r) - corr + wrap, where corr = 1 iff
    isa_m < r and c == text[m-1], wrap = 1 iff c == text[e-1] and the
    gt bit is set (same recurrence, two-word carry discipline)."""
    rk_hi, rk_lo = rank_batch_w(w, c, r_hi, r_lo)
    cnt_hi = _select_small(cf_hi, c)
    cnt_lo = _select_small(cf_lo, c)
    cu = c.astype(jnp.uint32)
    lt = jnp.logical_or(
        consts_hi[0] < r_hi,
        jnp.logical_and(consts_hi[0] == r_hi, consts_lo[0] < r_lo))
    corr = jnp.logical_and(lt, cu == consts_lo[1]).astype(jnp.uint32)
    wrap = jnp.logical_and(cu == consts_lo[2], g0 == 1).astype(jnp.uint32)
    lo1 = cnt_lo + rk_lo
    c1 = (lo1 < cnt_lo).astype(jnp.uint32)
    lo2 = lo1 + wrap
    c2 = jnp.logical_and(wrap == 1, lo2 == 0).astype(jnp.uint32)
    b3 = jnp.logical_and(corr == 1, lo2 == 0).astype(jnp.uint32)
    lo3 = lo2 - corr
    hi3 = cnt_hi + rk_hi + c1 + c2 - b3
    return (jnp.where(active, hi3, r_hi), jnp.where(active, lo3, r_lo))


def _chain_chunk_w_impl(outer: int, w: WideOcc, text_rows, gt_rows,
                        lo0_row, cf_hi, cf_lo, consts_hi, consts_lo,
                        start_rows, afrom, ato, gap, rhi0, rlo0, k0,
                        samp_idx):
    """outer*256 wide steps for all lanes; histogram cell = two-word
    rank, recorded as (row int32, col int32) pairs through the scan."""

    def outer_body(carry, o):
        r_hi, r_lo = carry
        kbase = k0 + o * 256
        trow, grow = _read_tg(text_rows, gt_rows, start_rows, lo0_row,
                              kbase)

        def inner(carry, i):
            r_hi, r_lo = carry
            c, g0 = _col_read(trow, grow, i)
            k = kbase + i
            active = jnp.logical_and(k >= afrom, k < ato)
            r_hi, r_lo = _chain_step_w(w, cf_hi, cf_lo, consts_hi,
                                       consts_lo, r_hi, r_lo, c, g0,
                                       active)
            row = ((r_hi << jnp.uint32(24))
                   | (r_lo >> jnp.uint32(8))).astype(jnp.int32)
            y_row = jnp.where(active, row, _SENT_ROW)
            y_col = (r_lo & jnp.uint32(255)).astype(jnp.int32)
            return (r_hi, r_lo), (y_row, y_col)

        carry, ys = lax.scan(inner, (r_hi, r_lo),
                             jnp.arange(256, dtype=jnp.int32))
        return carry, ys

    (r_hi, r_lo), (yrow, ycol) = lax.scan(
        outer_body, (rhi0, rlo0), jnp.arange(outer, dtype=jnp.int32))
    T = start_rows.shape[0]
    yrow = yrow.reshape(outer * 256, T)
    ycol = ycol.reshape(outer * 256, T)
    gap = gap.at[yrow.reshape(-1), ycol.reshape(-1)].add(1, mode="drop")
    samp_row = jnp.take_along_axis(yrow, samp_idx, axis=0)
    samp_col = jnp.take_along_axis(ycol, samp_idx, axis=0)
    return r_hi, r_lo, gap, samp_row, samp_col


_chain_chunk_w = partial(jax.jit, static_argnums=(0,),
                         donate_argnums=(12,))(_chain_chunk_w_impl)


def _anchor_chunk_w_impl(outer: int, w: WideOcc, text_rows, gt_rows,
                         lo0_row, cf_hi, cf_lo, consts_hi, consts_lo,
                         start_rows, afrom, ato, rhi0, rlo0, k0):
    def outer_body(carry, o):
        kbase = k0 + o * 256
        trow, grow = _read_tg(text_rows, gt_rows, start_rows, lo0_row,
                              kbase)

        def inner(i, carry):
            r_hi, r_lo = carry
            c, g0 = _col_read(trow, grow, i)
            k = kbase + i
            active = jnp.logical_and(k >= afrom, k < ato)
            return _chain_step_w(w, cf_hi, cf_lo, consts_hi, consts_lo,
                                 r_hi, r_lo, c, g0, active)

        return lax.fori_loop(0, 256, inner, carry), 0

    carry, _ = lax.scan(outer_body, (rhi0, rlo0),
                        jnp.arange(outer, dtype=jnp.int32))
    return carry


_anchor_chunk_w = partial(jax.jit, static_argnums=(0,))(
    _anchor_chunk_w_impl)


def _split64(v) -> Tuple[np.ndarray, np.ndarray]:
    a = np.asarray(v, np.uint64)
    return ((a >> np.uint64(32)).astype(np.uint32),
            (a & np.uint64(0xFFFFFFFF)).astype(np.uint32))


class WideDeviceGapRunner(DeviceGapRunner):
    """DeviceGapRunner with two-word lane ranks.  Constructed from a
    WideOcc (widen_focc over a chunk-built structure); the interface —
    anchor / run_chains / gap fetch / sample harvest — matches the
    narrow runner, with rank values as int64 on the host side."""

    WIDE = True

    def __init__(self, wocc: WideOcc, text_rows, text_host, s, m, e,
                 isa_m, first_hist, **kw):
        super().__init__(wocc.focc, text_rows, text_host, s, m, e,
                         isa_m, first_hist, **kw)
        self.wocc = wocc
        cf64 = np.concatenate(
            [[0], np.cumsum(np.asarray(first_hist, np.uint64))[:-1]])
        hi, lo = _split64(cf64)
        self.cf_hi, self.cf_lo = jnp.asarray(hi), jnp.asarray(lo)
        ihi, ilo = _split64([isa_m])
        self.consts_hi = jnp.asarray(
            np.array([ihi[0], 0, 0], np.uint32))
        self.consts_lo = jnp.asarray(np.array(
            [ilo[0], self.sym_before_m, self.sym_last], np.uint32))
        self._g8_cache = None

    # ------------------------------------------------------------ anchor

    def _run_anchor_dev(self, starts, lbs, r0_val):
        walk_start = starts + lbs
        self._ensure_gt(int(walk_start.max()) + 1)
        rows, af, at, _ = self._align(walk_start, lbs)
        hi0, lo0 = _split64([r0_val])
        r_hi = jnp.full(self.lane_bucket, hi0[0], jnp.uint32)
        r_lo = jnp.full(self.lane_bucket, lo0[0], jnp.uint32)
        saj, afj, atj = jnp.asarray(rows), jnp.asarray(af), jnp.asarray(at)
        max_steps = int(at.max())
        done = 0
        while done < max_steps:
            outer = chunk_outer(max_steps - done)
            r_hi, r_lo = _anchor_chunk_w(
                outer, self.wocc, self.text_rows, self.gt_rows,
                jnp.int32(self.lo0 // TEXT_BLOCK), self.cf_hi, self.cf_lo,
                self.consts_hi, self.consts_lo, saj, afj, atj,
                r_hi, r_lo, jnp.int32(done))
            done += outer * 256
        return r_hi, r_lo

    def _anchor_materialize(self, r_dev, k: int) -> np.ndarray:
        r_hi, r_lo = r_dev
        return (np.asarray(r_hi)[:k].astype(np.int64) << 32) \
            | np.asarray(r_lo)[:k].astype(np.int64)

    # ------------------------------------------------------------ chains

    def run_chains(self, starts, seeds, lens, force_int32=False):
        T = self.lane_bucket
        self._g8_cache = None
        # scatter rows are int32: rank spaces to ~2^39 cells
        assert self.gap_size + 2 <= ((1 << 31) - 2) * 256, \
            "rank space exceeds int32 histogram rows"
        grows = _pad_pow2((self.gap_size + 2 + 255) // 256, lo=4)
        self._samples = []
        gdt = jnp.int32 if force_int32 else self.gap_dtype
        self.gap = jnp.zeros((grows, 256), gdt)
        self._ensure_gt(int(starts.max()) + 1)
        rows, af, at, aligned = self._align(starts, lens)
        shi = np.zeros(T, np.uint32)
        slo = np.zeros(T, np.uint32)
        hi, lo = _split64(seeds)
        shi[: len(starts)], slo[: len(starts)] = hi, lo
        r_hi, r_lo = jnp.asarray(shi), jnp.asarray(slo)
        saj, afj, atj = jnp.asarray(rows), jnp.asarray(af), jnp.asarray(at)
        max_steps = int(at.max())
        rate = self.sample_rate
        aligned_abs = aligned + self.lo0
        phase = (aligned_abs % rate).astype(np.int64) if rate else None
        done = 0
        while done < max_steps:
            outer = chunk_outer(max_steps - done)
            chunklen = outer * 256
            if rate:
                nsamp = chunklen // rate + 1
                k0p = (phase - done) % rate
                idx = (k0p[None, :] + rate * np.arange(nsamp)[:, None])
                valid = idx < chunklen
                idxc = np.zeros((nsamp, T), np.int32)
                idxc[:, : len(starts)] = np.minimum(idx, chunklen - 1)
            else:
                nsamp = 1
                idxc = np.zeros((1, T), np.int32)
                valid = None
            r_hi, r_lo, self.gap, srow, scol = _chain_chunk_w(
                outer, self.wocc, self.text_rows, self.gt_rows,
                jnp.int32(self.lo0 // TEXT_BLOCK), self.cf_hi, self.cf_lo,
                self.consts_hi, self.consts_lo, saj, afj, atj, self.gap,
                r_hi, r_lo, jnp.int32(done), jnp.asarray(idxc))
            if rate:
                # device handles only — fetching here would sync every
                # chunk; harvest_samples combines rows/cols after the
                # last chunk
                self._samples.append((done, (srow, scol), valid))
            done += chunklen
        k = len(starts)
        self.final_rs = (np.asarray(r_hi)[:k].astype(np.int64) << 32) \
            | np.asarray(r_lo)[:k].astype(np.int64)
        self._lanes = (starts.copy(), lens.copy(), aligned_abs.copy(),
                       af[:k].copy(), at[:k].copy())

    # ------------------------------------------------------------ results

    def harvest_samples(self):
        """Reconstruct the two-word ranks from their histogram cell
        coordinates (r = row * 256 + col, row = hi<<24 | lo>>8) at
        materialization time, then reuse the base harvest."""
        k = len(self._lanes[0]) if self._lanes else 0
        conv = []
        for done, sc_pair, valid in self._samples:
            if isinstance(sc_pair, tuple):
                sr = np.asarray(sc_pair[0], np.int64)[:, :k]
                sc = np.asarray(sc_pair[1], np.int64)[:, :k]
                sc_pair = (sr << 8) | sc
            conv.append((done, sc_pair, valid))
        self._samples = conv
        return super().harvest_samples()

    def fetch_gap_compressed(self):
        if self._g8_cache is None:
            self._g8_cache = super().fetch_gap_compressed()
        return self._g8_cache

    def gap_checksum(self) -> int:
        """Exact int64 checksum via a DEVICE (hi, lo) pair reduction —
        a plain uint32 reduction would wrap (wide block lengths exceed
        2^32), and a byte-compressed host fetch would cost 1 B/rank
        even when the device zip needs no fetch."""
        from .devzip import gap_checksum_w
        return gap_checksum_w(self.gap)

"""Batched same-level gap computation — every pair merge of one merge-tree
level in SHARED device dispatches.

The per-pair DeviceGapRunner (ops/gapdev.py) pays fixed costs per merge:
anchor contraction dispatches (2048 masked steps each regardless of the
64-step default lookback), chain-chunk ramp-up/tail waves, one rank-row
build pipeline, one gap fetch.  At the bushy bottom of the tree (the
reference's "independent merges at the same level run concurrently",
SURVEY.md section 2.3.3, arXiv:1604.06687 parallel merging) a 3.2 Gbp /
128 M-block build has 12 such merges per level — 12x the fixed costs for
work that is embarrassingly batchable.

This module runs the K merges of a level as ONE lane population:

- the K right regions' rank rows are CONCATENATED row-wise.  Both fused
  layouts (ops/focc.py byte rows, ops/focc_bp.py bit-plane rows) keep a
  block's symbols AND its occ checkpoint in the same self-contained
  256-rank row, so a lane of merge k addresses its own region with the
  GLOBAL rank g = B_k * 256 + r_local (B_k = the region's first row):
  row = g >> 8 lands in region k, col = g & 255 is the local offset, and
  the gathered checkpoint bytes are region-local counts.  Every rank
  query of every merge goes through the same one-row gather kernel.
- per-merge constants become per-lane vectors: the recurrence's
  cnt_lt(c) table is pre-offset by B_k * 256 (so lane ranks STAY global
  across steps), isa_m / sym_before_m / sym_last ride as [T] words, and
  the gt bit rows of all left blocks concatenate with per-lane row bases.
- ONE gap histogram spans the concatenated rank space (region gutters —
  the checkpoint row of each region — guarantee cell disjointness), so
  the per-chunk scatter-add, the compressed fetch and the overflow
  gather each run once per level instead of once per merge.

Anchors batch the same way: all merges' lane-boundary contractions run in
one lane population, so an anchor dispatch costs the same whether the
level has 1 merge or 12, and lookback-extension rounds proceed jointly.

All lanes share the 256-column schedule because every block base is
0 mod 256 and walk starts are phase-aligned (ops/gapdev.py docstring).
Reference: SURVEY.md section 3.1 phase 3 (HOT LOOP #2), bwtb3m.cpp:49
numthreads block/merge task parallelism.
"""

from __future__ import annotations

import os
from functools import partial
from typing import List, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from .focc import FusedOcc, _pad_rows, _row_width, rank_batch_f
from .focc_bp import WPR, FusedOccBP
from .focc_build import _bp_chunk, _bytes_chunk, _pack_host
from .gapdev import TEXT_BLOCK, _col_read, _pad_pow2, cnt_le_from_gap, \
    chunk_outer

BLOCK = 256
_CHUNK_ROWS = 1 << 17            # focc build chunk (32 M symbols)


# ----------------------------------------------------------------- builders

def build_focc_concat(bwts: List[np.ndarray], sigma: int
                      ) -> Tuple[object, np.ndarray]:
    """One rank structure over K concatenated right regions.  Returns
    (focc, row_bases int64 [K]): region k answers local rank queries at
    global positions B_k * 256 + r, B_k = row_bases[k].  Each region
    keeps its nb_k + 1 rows (the trailing occ checkpoint row serves
    queries at r == |M_k|) — the +1 row is the inter-region gutter that
    keeps gap-histogram cells disjoint.  Chunk programs are the shared
    ones from ops/focc_build.py (global row starts, per-region running
    base), so row contents are byte-identical to per-region builds."""
    bitplane = sigma <= 8 and os.environ.get("BWTB3M_FOCC") != "legacy"
    bits = 4 if sigma <= 15 or bitplane else 8
    roww = 4 * WPR if bitplane else _row_width(sigma, BLOCK)
    nbs = [max(1, (len(b) + BLOCK - 1) // BLOCK) for b in bwts]
    row_bases = np.zeros(len(bwts), np.int64)
    row_bases[1:] = np.cumsum([nb + 1 for nb in nbs])[:-1]
    total_rows = int(row_bases[-1] + nbs[-1] + 1)
    g = min(_CHUNK_ROWS, _pad_rows(total_rows))
    # headroom g: the last chunk of a region may overshoot its rows (the
    # next region overwrites them; trailing overshoot must stay in pad)
    nb_pad = _pad_rows(total_rows + g)
    g = min(g, nb_pad)
    rows = jnp.zeros((nb_pad, roww), jnp.int8)
    gsym = g * BLOCK
    for k, bwt in enumerate(bwts):
        bwt = np.ascontiguousarray(bwt, dtype=np.uint8)
        base = jnp.zeros((sigma,), jnp.uint32)
        nfull = jnp.int32(row_bases[k] + len(bwt) // BLOCK)
        nrem = jnp.int32(len(bwt) % BLOCK)
        nchunks = (nbs[k] + 1 + g - 1) // g
        for j in range(nchunks):
            chunk = bwt[j * gsym : (j + 1) * gsym]
            if len(chunk) < gsym:
                chunk = np.concatenate(
                    [chunk, np.zeros(gsym - len(chunk), np.uint8)])
            packed = _pack_host(chunk, bits)
            packed = jnp.asarray(packed)
            start = jnp.int32(row_bases[k] + j * g)
            if bitplane:
                rows, base = _bp_chunk(g, sigma, bits, packed, base, rows,
                                       start, nfull, nrem)
            else:
                rows, base = _bytes_chunk(g, sigma, bits, roww, packed,
                                          base, rows, start, nfull, nrem)
    C = jnp.zeros(sigma + 1, jnp.uint32)     # unused by the chain kernels
    n_virt = total_rows * BLOCK
    focc = (FusedOccBP(rows, C, n_virt, sigma) if bitplane
            else FusedOcc(rows, C, n_virt, sigma, BLOCK))
    return focc, row_bases


def build_focc_concat_dev(region_rows: List[object], lens: List[int],
                          sigma: int) -> Tuple[object, np.ndarray]:
    """build_focc_concat from DEVICE-resident packed region rows
    (ops/devzip.py layout): no host pack, no host->device transfer —
    the round-4 device-resident merge tree's level rank build."""
    from .focc_build import _rows_chunk_slice
    bitplane = sigma <= 8 and os.environ.get("BWTB3M_FOCC") != "legacy"
    roww = 4 * WPR if bitplane else _row_width(sigma, BLOCK)
    bits = 4 if region_rows[0].shape[1] == BLOCK // 2 else 8
    assert not (bitplane and bits != 4)
    nbs = [max(1, (ln + BLOCK - 1) // BLOCK) for ln in lens]
    row_bases = np.zeros(len(lens), np.int64)
    row_bases[1:] = np.cumsum([nb + 1 for nb in nbs])[:-1]
    total_rows = int(row_bases[-1] + nbs[-1] + 1)
    g = min(_CHUNK_ROWS, _pad_rows(total_rows))
    nb_pad = _pad_rows(total_rows + g)
    g = min(g, nb_pad)
    rows = jnp.zeros((nb_pad, roww), jnp.int8)
    for k, (src, ln) in enumerate(zip(region_rows, lens)):
        base = jnp.zeros((sigma,), jnp.uint32)
        nfull = jnp.int32(row_bases[k] + ln // BLOCK)
        nrem = jnp.int32(ln % BLOCK)
        nchunks = (nbs[k] + 1 + g - 1) // g
        for j in range(nchunks):
            packed = _rows_chunk_slice(src, j * g, g)
            start = jnp.int32(row_bases[k] + j * g)
            if bitplane:
                rows, base = _bp_chunk(g, sigma, bits, packed, base, rows,
                                       start, nfull, nrem)
            else:
                rows, base = _bytes_chunk(g, sigma, bits, roww, packed,
                                          base, rows, start, nfull, nrem)
    C = jnp.zeros(sigma + 1, jnp.uint32)
    n_virt = total_rows * BLOCK
    focc = (FusedOccBP(rows, C, n_virt, sigma) if bitplane
            else FusedOcc(rows, C, n_virt, sigma, BLOCK))
    return focc, row_bases


def concat_bytes_estimate(right_lens: List[int], left_total: int,
                          sigma: int) -> int:
    """HBM bytes the batched level state needs beyond the engine-wide
    text rows: concatenated rank rows + u16 gap histogram + full-span gt
    rows (the gate `_level_fits` uses)."""
    bitplane = sigma <= 8 and os.environ.get("BWTB3M_FOCC") != "legacy"
    roww = 4 * WPR if bitplane else _row_width(sigma, BLOCK)
    total_rows = sum((ln + BLOCK - 1) // BLOCK + 1 for ln in right_lens)
    rank_space = total_rows * BLOCK
    rows_b = _pad_rows(total_rows + _CHUNK_ROWS) * roww
    gap_b = _pad_pow2((rank_space + 2 + 255) // 256, lo=4) * 256 * 2
    gt_b = ((left_total + sum(right_lens)) // 8)
    return rows_b + gap_b + gt_b


# ------------------------------------------------------------------ kernels

def _select_rows_small(tab: jnp.ndarray, idx: jnp.ndarray) -> jnp.ndarray:
    """tab[j, idx[j]] for a per-lane small table via compare-mask."""
    col = lax.broadcasted_iota(jnp.int32, tab.shape, 1)
    return jnp.sum(jnp.where(col == idx[:, None], tab, tab.dtype.type(0)),
                   axis=1)


def _chain_step_mk(focc, cbase: jnp.ndarray, isa_g: jnp.ndarray,
                   symb: jnp.ndarray, syml: jnp.ndarray, r: jnp.ndarray,
                   c: jnp.ndarray, g0: jnp.ndarray,
                   active: jnp.ndarray) -> jnp.ndarray:
    """One masked recurrence step, per-lane merge constants.  cbase[t, c]
    = B_k(t) * 256 + cnt_lt_k(t)(c) (uint32; pre-offsetting by the row
    base keeps lane ranks global across steps), isa_g = B_k * 256 +
    isa_m_k, symb/syml = sym_before_m_k / sym_last_k."""
    rk = rank_batch_f(focc, c, r)            # region-local occ count
    cnt = _select_rows_small(cbase, c)
    cu = c.astype(jnp.uint32)
    corr = jnp.logical_and(isa_g < r,
                           cu == symb).astype(jnp.uint32)
    wrap = jnp.logical_and(cu == syml, g0 == 1).astype(jnp.uint32)
    r_new = cnt + rk - corr + wrap
    return jnp.where(active, r_new, r)


def _read_tg_mk(text_rows, gt_rows, start_rows, lo0_rows, gt_base, gt_len1,
                kbase):
    """Per-lane row gathers: absolute text rows (shared schedule) + the
    lane's own region span of the concatenated gt rows."""
    prow = jnp.maximum(start_rows - (kbase >> 8), 0)
    trow = jnp.take(
        text_rows, jnp.minimum(prow, text_rows.shape[0] - 1), axis=0)
    gidx = jnp.minimum(jnp.maximum(prow - lo0_rows, 0), gt_len1) + gt_base
    grow = jnp.take(gt_rows, jnp.minimum(gidx, gt_rows.shape[0] - 1),
                    axis=0)
    return trow, grow


def _chain_chunk_mk_impl(outer: int, focc, text_rows, gt_rows, lo0_rows,
                         gt_base, gt_len1, cbase, isa_g, symb, syml,
                         start_rows, afrom, ato, gap, r0, k0, samp_idx):
    """outer*256 steps for all lanes of all merges; every R lands in the
    level-global gap histogram (global rank = global cell)."""
    sentinel = jnp.uint32(0xFFFFFFFF)

    def outer_body(r, o):
        kbase = k0 + o * 256
        trow, grow = _read_tg_mk(text_rows, gt_rows, start_rows, lo0_rows,
                                 gt_base, gt_len1, kbase)

        def inner(r, i):
            c, g0 = _col_read(trow, grow, i)
            k = kbase + i
            active = jnp.logical_and(k >= afrom, k < ato)
            r = _chain_step_mk(focc, cbase, isa_g, symb, syml, r, c, g0,
                               active)
            y = jnp.where(active, r, sentinel)
            return r, y

        r, ys = lax.scan(inner, r, jnp.arange(256, dtype=jnp.int32))
        return r, ys

    r, ys = lax.scan(outer_body, r0, jnp.arange(outer, dtype=jnp.int32))
    ys_flat = ys.reshape(outer * 256, start_rows.shape[0])
    yr = ys_flat.reshape(-1)
    gap = gap.at[(yr >> jnp.uint32(8)).astype(jnp.int32),
                 (yr & jnp.uint32(255)).astype(jnp.int32)].add(
        1, mode="drop")
    samp = jnp.take_along_axis(ys_flat, samp_idx, axis=0)
    return r, gap, samp


_chain_chunk_mk = partial(jax.jit, static_argnums=(0,),
                          donate_argnums=(14,))(_chain_chunk_mk_impl)


def _anchor_chunk_mk_impl(outer: int, focc, text_rows, gt_rows, lo0_rows,
                          gt_base, gt_len1, cbase, isa_g, symb, syml,
                          start_rows, afrom, ato, r0, k0):
    def outer_body(r, o):
        kbase = k0 + o * 256
        trow, grow = _read_tg_mk(text_rows, gt_rows, start_rows, lo0_rows,
                                 gt_base, gt_len1, kbase)

        def inner(i, r):
            c, g0 = _col_read(trow, grow, i)
            k = kbase + i
            active = jnp.logical_and(k >= afrom, k < ato)
            return _chain_step_mk(focc, cbase, isa_g, symb, syml, r, c, g0,
                                  active)

        return lax.fori_loop(0, 256, inner, r), 0

    r, _ = lax.scan(outer_body, r0, jnp.arange(outer, dtype=jnp.int32))
    return r


_anchor_chunk_mk = partial(jax.jit, static_argnums=(0,))(
    _anchor_chunk_mk_impl)


# ------------------------------------------------------------------- runner

class _MergeSpec:
    """Host bookkeeping for one pair merge inside the batch."""

    def __init__(self, k, s, m, e, isa_m, rbase):
        self.k = k
        self.s, self.m, self.e = int(s), int(m), int(e)
        self.isa_m = int(isa_m)
        self.rbase = int(rbase)          # global rank base (B_k * 256)
        self.gap_size = self.e - self.m
        self.lo0 = (self.s // TEXT_BLOCK) * TEXT_BLOCK
        # gt rows span the FULL pair [lo0, e-1) so lookback extensions
        # never shift the concat layout (only coverage grows)
        self.gt_rows_full = max(
            1, (self.e - 1 - self.lo0 + TEXT_BLOCK - 1) // TEXT_BLOCK)
        self.gt_cap = 0                  # positions < gt_cap have bits
        self.gt_base = 0                 # row base in the concat gt array
        # chain lane span [lane0, lane0 + T_k) and results, set later
        self.lane0 = 0
        self.T = 0
        self.starts = None
        self.lens = None
        self.seeds = None
        self.final_rs = None


class BatchedGapRunner:
    """Gap arrays for K same-level pair merges in shared dispatches.

    merges: list of (s, m, e, right_bwt, isa_m, first_hist); shared state
    comes from the engine ctx (global text rows / host text / sigma).
    After ``compute()``, per-merge results come from ``view(k)`` — an
    adapter with the DeviceGapRunner result surface (final_rs,
    harvest_samples, fetch_gap_compressed, cnt_le_at_host) so the engine
    finishes each merge exactly like the per-pair path."""

    def __init__(self, text_rows, text_host: np.ndarray, sigma: int,
                 merges, lane_bucket: int = 1 << 16, sample_rate: int = 0,
                 nthreads: int = 4, log=None, right_rows=None, mesh=None):
        self.mesh = mesh       # lane-shard the level over a device mesh
        self._mesh_fns = {}
        if mesh is not None:
            assert lane_bucket % int(mesh.devices.size) == 0
        self.text_rows = text_rows
        self.text = text_host
        self.n = len(text_host)
        self.sigma = int(sigma)
        self.lane_bucket = lane_bucket
        self.sample_rate = int(sample_rate)
        self.nthreads = nthreads
        self.log = log
        right_lens = [m[2] - m[1] for m in merges]
        if right_rows is not None:
            # device-resident regions (round-4 device tree): level rank
            # rows build straight from the children's device rows
            self.focc, row_bases = build_focc_concat_dev(
                right_rows, right_lens, self.sigma)
        else:
            right_bwts = [m[3] for m in merges]
            self.focc, row_bases = build_focc_concat(right_bwts,
                                                     self.sigma)
        self.total_rank = int(row_bases[-1] * BLOCK + right_lens[-1] + 1)
        assert (row_bases[-1] + (right_lens[-1] + 255) // 256 + 2
                <= (1 << 24) - 1), \
            "level rank space must stay 256 short of 2^32"
        self.specs: List[_MergeSpec] = []
        cbase_rows = np.zeros((len(merges), self.sigma), np.uint32)
        self._symb = np.zeros(len(merges), np.uint32)
        self._syml = np.zeros(len(merges), np.uint32)
        self._isa_g = np.zeros(len(merges), np.uint32)
        gt_off = 0
        for k, (s, m, e, _bwt, isa_m, first_hist) in enumerate(merges):
            spec = _MergeSpec(k, s, m, e, isa_m, int(row_bases[k]) * BLOCK)
            spec.gt_base = gt_off
            gt_off += spec.gt_rows_full
            self.specs.append(spec)
            cnt_lt = np.concatenate(
                [[0], np.cumsum(first_hist)[:-1]]).astype(np.uint64)
            cbase_rows[k] = ((spec.rbase + cnt_lt) & 0xFFFFFFFF).astype(
                np.uint32)
            self._symb[k] = int(text_host[(m - 1) % self.n])
            self._syml[k] = int(text_host[(e - 1) % self.n])
            self._isa_g[k] = np.uint32((spec.rbase + isa_m) & 0xFFFFFFFF)
        self._cbase_rows = cbase_rows
        self._gt_total = gt_off
        self._gt_packed = np.zeros(
            (_pad_pow2(gt_off, lo=4), TEXT_BLOCK // 8), np.uint8)
        self.gt_rows = None
        self._gt_dirty = True
        self.gap = None
        self._row_sums = None
        self._g8 = None
        self._ov_idx = None
        self._ov_val = None
        self._samples: list = []
        self._lane_maps = None

    # ---------------------------------------------------------------- gt

    def _ensure_gt(self, caps: List[int]) -> None:
        """Extend each merge's wrap-term bits to cover walk positions
        [s_k, caps[k]); concat layout is fixed, so only new bits are
        computed and the device copy re-uploads when anything grew."""
        from .. import native
        for spec, cap in zip(self.specs, caps):
            cap = min(cap, spec.e - 1)
            if cap <= spec.gt_cap:
                continue
            lo = max(spec.s, spec.gt_cap)
            syml = int(self._syml[spec.k])
            ps = lo + np.flatnonzero(
                np.asarray(self.text[lo:cap]) == syml).astype(np.int64)
            xs = ps + 1
            if len(xs):
                bits = native.cmp_rot(self.text, self.n, spec.e % self.n,
                                      xs, self.nthreads)
                if bits is not None:
                    gt = (bits > 0).astype(np.uint8)
                else:
                    from .gap import gt_against
                    gt = gt_against(self.text.astype(np.int32),
                                    spec.e % self.n, xs)
                offs = ps - spec.lo0
                sub = self._gt_packed[
                    spec.gt_base : spec.gt_base + spec.gt_rows_full]
                np.bitwise_or.at(
                    sub.reshape(-1), offs >> 3,
                    (gt << (offs & 7).astype(np.uint8)).astype(np.uint8))
            spec.gt_cap = cap
            self._gt_dirty = True
        if self._gt_dirty:
            self.gt_rows = jnp.asarray(self._gt_packed)
            self._gt_dirty = False

    # ------------------------------------------------------------- lanes

    def _lane_tables(self, kid: np.ndarray, starts: np.ndarray,
                     lens: np.ndarray):
        """Per-lane kernel arrays for a lane population described by
        (merge id, absolute start position, walk length) triples, padded
        to lane_bucket."""
        T = self.lane_bucket
        assert len(kid) <= T, (len(kid), T)
        lo0 = np.array([self.specs[k].lo0 for k in kid], np.int64)
        start_off = starts - lo0
        aligned = ((start_off + 1 + 255) // 256) * 256 - 1
        afrom = aligned - start_off
        ato = afrom + lens
        rows = np.zeros(T, np.int32)
        af = np.zeros(T, np.int32)
        at = np.zeros(T, np.int32)
        l0r = np.zeros(T, np.int32)
        gtb = np.zeros(T, np.int32)
        gtl = np.zeros(T, np.int32)
        cb = np.zeros((T, self.sigma), np.uint32)
        isg = np.zeros(T, np.uint32)
        syb = np.zeros(T, np.uint32)
        syl = np.zeros(T, np.uint32)
        kN = len(kid)
        rows[:kN] = (aligned + lo0) >> 8
        af[:kN] = afrom
        at[:kN] = ato
        l0r[:kN] = lo0 >> 8
        gtb[:kN] = [self.specs[k].gt_base for k in kid]
        gtl[:kN] = [self.specs[k].gt_rows_full - 1 for k in kid]
        cb[:kN] = self._cbase_rows[kid]
        isg[:kN] = self._isa_g[kid]
        syb[:kN] = self._symb[kid]
        syl[:kN] = self._syml[kid]
        jt = [jnp.asarray(x) for x in
              (l0r, gtb, gtl, cb, isg, syb, syl, rows, af, at)]
        return jt, af[:kN], at[:kN], aligned + lo0

    def _run_anchor_pass(self, kid, starts, lbs, r0_global) -> np.ndarray:
        walk_start = starts + lbs
        caps = [0] * len(self.specs)
        for k, w in zip(kid, walk_start):
            caps[k] = max(caps[k], int(w) + 1)
        self._ensure_gt(caps)
        jt, af, at, _ = self._lane_tables(kid, walk_start, lbs)
        r = np.zeros(self.lane_bucket, np.uint32)
        r[: len(kid)] = r0_global
        r = jnp.asarray(r)
        max_steps = int(at.max())
        done = 0
        while done < max_steps:
            outer = chunk_outer(max_steps - done)
            if self.mesh is not None:
                fn = self._mesh_fn("anchor", outer)
                r = fn(self.focc, self.text_rows, self.gt_rows, *jt, r,
                       jnp.int32(done))
            else:
                r = _anchor_chunk_mk(outer, self.focc, self.text_rows,
                                     self.gt_rows, *jt, r,
                                     jnp.int32(done))
            done += outer * 256
        return np.asarray(r)[: len(kid)].astype(np.int64)

    def _mesh_fn(self, kind: str, outer: int):
        key = (kind, outer)
        if key not in self._mesh_fns:
            from ..parallel.merge import (sharded_batched_anchor_fn,
                                          sharded_batched_chain_fn)
            mk = (sharded_batched_anchor_fn if kind == "anchor"
                  else sharded_batched_chain_fn)
            self._mesh_fns[key] = mk(self.mesh, outer)
        return self._mesh_fns[key]

    def anchor_all(self, anchor_lookback: int = 64) -> None:
        """Seed ranks for every merge's interior lane boundaries, all
        merges contracted jointly (one dispatch per lookback round)."""
        kid_l, starts_l = [], []
        for spec in self.specs:
            block_len = spec.m - spec.s
            T = max(1, min(self._lane_budget(spec), block_len // 64 or 1))
            bounds = np.linspace(spec.s, spec.m, T + 1).astype(np.int64)
            spec.starts = bounds[1:] - 1
            spec.lens = np.diff(bounds)
            spec.T = T
            spec.seeds = np.zeros(T, np.int64)
            spec.seeds[T - 1] = spec.rbase + self._r_start_right[spec.k]
            if T > 1:
                kid_l.append(np.full(T - 1, spec.k, np.int64))
                starts_l.append(spec.starts[: T - 1])
        if not kid_l:
            return
        kid = np.concatenate(kid_l)
        starts = np.concatenate(starts_l)
        gapsz = np.array([self.specs[k].gap_size for k in kid], np.int64)
        rbase = np.array([self.specs[k].rbase for k in kid], np.int64)
        e_arr = np.array([self.specs[k].e for k in kid], np.int64)
        seeds = np.zeros(len(kid), np.int64)
        todo = np.arange(len(kid))
        lb = anchor_lookback
        while len(todo):
            lbs = np.minimum(min(lb, self.n), (e_arr[todo] - 2)
                             - starts[todo])
            lbs = np.maximum(lbs, 1)
            lo = self._run_anchor_pass(kid[todo], starts[todo], lbs,
                                       rbase[todo])
            hi = self._run_anchor_pass(kid[todo], starts[todo], lbs,
                                       rbase[todo] + gapsz[todo])
            ok = lo == hi
            seeds[todo[ok]] = lo[ok]
            todo = todo[~ok]
            if len(todo) and lb >= self.n:
                raise AssertionError(
                    "anchor unresolved at full lookback — equal-rotation "
                    "boundary should be impossible for interior anchors")
            lb = min(lb * 4, self.n)
            if len(todo) and self.log:
                self.log.v("batched anchors: lookback extended to %d for "
                           "%d lanes" % (lb, len(todo)))
        # scatter seeds back per merge
        off = 0
        for spec in self.specs:
            if spec.T > 1:
                spec.seeds[: spec.T - 1] = seeds[off : off + spec.T - 1]
                off += spec.T - 1

    def _lane_budget(self, spec: _MergeSpec) -> int:
        """Lanes for one merge: proportional to its left-block share of
        the level (largest-remainder not needed — floors always fit)."""
        total = sum(sp.m - sp.s for sp in self.specs)
        share = (spec.m - spec.s) * self.lane_bucket // max(1, total)
        return max(1, share)

    # ------------------------------------------------------------- chains

    def compute(self, r_start_right: List[int],
                anchor_lookback: int = 64, fetch_host: bool = True
                ) -> None:
        """Anchors + chains + gap fetch for all merges. r_start_right[k]
        = right region k's r_start (the last lane's seed).
        ``fetch_host=False`` keeps the histogram on device (the device-
        tree zip consumes it there) and only derives the per-merge
        checksums; fetch_gap_compressed is unavailable then."""
        self._r_start_right = list(r_start_right)
        self.anchor_all(anchor_lookback)
        kid = np.concatenate(
            [np.full(sp.T, sp.k, np.int64) for sp in self.specs])
        starts = np.concatenate([sp.starts for sp in self.specs])
        lens = np.concatenate([sp.lens for sp in self.specs])
        seeds = np.concatenate([sp.seeds for sp in self.specs])
        lane0 = 0
        for sp in self.specs:
            sp.lane0 = lane0
            lane0 += sp.T
        caps = [0] * len(self.specs)
        for k, st in zip(kid, starts):
            caps[k] = max(caps[k], int(st) + 1)
        self._ensure_gt(caps)
        grows = _pad_pow2((self.total_rank + 2 + 255) // 256, lo=4)
        assert grows < (1 << 24) - 1
        D = int(self.mesh.devices.size) if self.mesh is not None else 0
        if D:
            # per-device int32 partials (exact: no u16-wrap rerun)
            gap_sh = jnp.zeros((D, grows, 256), jnp.int32)
        else:
            self.gap = jnp.zeros((grows, 256), jnp.uint16)
        jt, af, at, aligned_abs = self._lane_tables(kid, starts, lens)
        T = self.lane_bucket
        r = np.zeros(T, np.uint32)
        r[: len(kid)] = seeds.astype(np.uint32)   # global seeds < 2^32
        r = jnp.asarray(r)
        max_steps = int(at.max())
        rate = self.sample_rate
        phase = (aligned_abs % rate).astype(np.int64) if rate else None
        self._samples = []
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
                idxc[:, : len(kid)] = np.minimum(idx, chunklen - 1)
            else:
                nsamp = 1
                idxc = np.zeros((1, T), np.int32)
                valid = None
            if D:
                fn = self._mesh_fn("chain", outer)
                r, gap_sh, samp = fn(
                    self.focc, self.text_rows, self.gt_rows, *jt,
                    gap_sh, r, jnp.int32(done), jnp.asarray(idxc))
            else:
                r, self.gap, samp = _chain_chunk_mk(
                    outer, self.focc, self.text_rows, self.gt_rows, *jt,
                    self.gap, r, jnp.int32(done), jnp.asarray(idxc))
            if rate:
                # device handle only: fetching here would sync every
                # chunk and stall the chain pipeline; all chunks fetch
                # in ONE round trip below
                self._samples.append((done, samp, valid))
            done += chunklen
        if D:
            # one reduction for the level (not one per step)
            self.gap = jnp.sum(gap_sh, axis=0, dtype=jnp.int32)
        if rate and self._samples:
            devs = [s for _d, s, _v in self._samples]
            host = np.asarray(devs[0]) if len(devs) == 1 else \
                np.asarray(jnp.concatenate(devs, axis=0))
            off = 0
            conv = []
            for d0, s, valid in self._samples:
                ns = s.shape[0]
                conv.append((d0, host[off : off + ns, : len(kid)], valid))
                off += ns
            self._samples = conv
        final = np.asarray(r)[: len(kid)].astype(np.int64)
        self._lane_maps = (kid, starts, lens, aligned_abs,
                           af[: len(kid)], at[: len(kid)])
        # per-merge: final ranks local, chain/anchor cross-check
        for sp in self.specs:
            sp.final_rs = final[sp.lane0 : sp.lane0 + sp.T] - sp.rbase
            if sp.T > 1:
                seeds_loc = sp.seeds - sp.rbase
                if not np.array_equal(sp.final_rs[1:], seeds_loc[:-1]):
                    bad = int(np.flatnonzero(
                        sp.final_rs[1:] != seeds_loc[:-1])[0])
                    raise AssertionError(
                        "anchor/chain mismatch (merge %d lane %d): %d != %d"
                        % (sp.k, bad + 1, sp.final_rs[bad + 1],
                           seeds_loc[bad]))
        if fetch_host:
            self._fetch_all()
        else:
            self._row_sums = np.asarray(
                jnp.sum(self.gap, axis=1, dtype=jnp.uint32)
            ).astype(np.int64)

    def _fetch_all(self) -> None:
        """One compressed fetch + one overflow gather for the level."""
        from .idx64 import take2d_u32
        self._row_sums = np.asarray(
            jnp.sum(self.gap, axis=1, dtype=jnp.uint32)).astype(np.int64)
        g8 = np.asarray(
            jnp.minimum(self.gap, 255).astype(jnp.uint8)).reshape(-1)
        self._g8 = g8
        ov = np.flatnonzero(g8 == 255).astype(np.int64)
        if len(ov):
            rows = (ov >> 8).astype(np.uint32)
            cols = (ov & 255).astype(np.uint32)
            self._ov_val = np.asarray(
                take2d_u32(self.gap, jnp.asarray(rows), jnp.asarray(cols)),
                dtype=np.int64)
        else:
            self._ov_val = np.zeros(0, np.int64)
        self._ov_idx = ov
        self.gap = None            # free the device histogram

    # ------------------------------------------------------------ results

    def checksum(self, k: int) -> int:
        sp = self.specs[k]
        r0 = sp.rbase // 256
        r1 = r0 + (sp.gap_size // 256) + 1
        return int(self._row_sums[r0:r1].sum())

    def view(self, k: int) -> "_MergeView":
        return _MergeView(self, self.specs[k])


class _MergeView:
    """DeviceGapRunner-shaped result adapter for one merge of the batch."""

    def __init__(self, runner: BatchedGapRunner, spec: _MergeSpec):
        self._r = runner
        self._sp = spec
        self.final_rs = spec.final_rs

    def fetch_gap_compressed(self):
        sp = self._sp
        g8 = self._r._g8[sp.rbase : sp.rbase + sp.gap_size + 1]
        oi, ov = self._r._ov_idx, self._r._ov_val
        m = (oi >= sp.rbase) & (oi <= sp.rbase + sp.gap_size)
        return g8, oi[m] - sp.rbase, ov[m]

    def cnt_le_at_host(self, ranks, gap8, ov_idx, ov_val):
        return cnt_le_from_gap(ranks, gap8, ov_idx, ov_val)

    def harvest_samples(self) -> Tuple[np.ndarray, np.ndarray]:
        r, sp = self._r, self._sp
        rate = r.sample_rate
        if not rate:
            return np.zeros(0, np.int64), np.zeros(0, np.int64)
        kid, starts, lens, aligned_abs, af, at = r._lane_maps
        sl = slice(sp.lane0, sp.lane0 + sp.T)
        a_abs, afk, atk = aligned_abs[sl], af[sl], at[sl]
        pos_all, val_all = [], []
        for done, samp, valid in r._samples:
            sub = samp[:, sl]
            nsamp = sub.shape[0]
            ks = ((a_abs % rate - done) % rate)[None, :] + \
                rate * np.arange(nsamp)[:, None] + done
            p = a_abs[None, :] - ks
            ok = (ks >= afk[None, :]) & (ks < atk[None, :]) & valid[:, sl]
            pos_all.append(p[ok])
            val_all.append(sub[ok].astype(np.int64) - sp.rbase)
        pos = np.concatenate(pos_all) if pos_all else np.zeros(0, np.int64)
        val = np.concatenate(val_all) if val_all else np.zeros(0, np.int64)
        order = np.argsort(pos)
        return pos[order], val[order]

"""Rank-range-sharded occ rows — per-merge state beyond one device's HBM.

The lane-sharded merge path (parallel/merge.py) replicates the right
region's rank rows on every device, so one pair merge is bounded by a
single device's HBM (ROADMAP "Still open" #3).  This module shards the
FusedOcc/FusedOccBP ROWS over the mesh axis instead: row b (rank range
[b*256, (b+1)*256)) lives only on device b // rows_per_shard, and a rank
query is answered by routing it to the owner — SPMD-style, every device
computes the masked contribution of its own row range and one ``psum``
assembles the full answer (queries are tiny next to rows; replicating
them costs nothing, and no all-to-all is needed because each query
touches exactly ONE row).

The gap histogram — the OTHER dominant per-merge buffer (u16, one cell
per right rank) — shards by the same rank ranges: after the psum each
device holds every lane's full new rank, and scatters only the cells it
owns (out-of-range local rows are dropped).  Net per-device state for
one merge: rows/D + hist/D, lifting the per-merge right-region bound
from one device's HBM to the mesh's aggregate.

Cost model: one [T]-lane uint32 ``psum`` per chain step rides the ICI
ring inside the compiled scan — latency-bound but tiny (256 KB at 65536
lanes); the row gathers themselves shrink per device.  Lanes are
REPLICATED here (memory scaling); the lane-sharded runner is the
compute-scaling variant, and a pod combines them one level up by giving
each pair merge of a tree level its own device group (SURVEY.md section
2.3.3).

Reference role: the sparse external gap files (`sparsetmpprefix`,
/root/reference/src/bwtb3m.cpp:53) — the reference's mechanism for gap
state that exceeds RAM — and the merge engine's rank oracle (SURVEY.md
section 3.1 HOT LOOP #2).
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..ops.focc import FusedOcc, rank_batch_f
from ..ops.focc_bp import FusedOccBP
from ..ops.gapdev import (TEXT_BLOCK, _pad_pow2, _read_tg, _col_read,
                          _select_small, chunk_outer)
from .mesh import AXIS


def shard_focc_rows(mesh: Mesh, focc, axis: str = AXIS):
    """Re-place the structure's rows sharded over the mesh axis (row =
    rank range owner); C stays replicated.  Rows are padded to a multiple
    of the axis size (queries never read pad rows: row <= nb always)."""
    D = int(mesh.devices.size)
    rows = focc.rows
    nbp = int(rows.shape[0])
    pad = (-nbp) % D
    if pad:
        rows = jnp.concatenate(
            [rows, jnp.zeros((pad, rows.shape[1]), rows.dtype)])
    rows = jax.device_put(rows, NamedSharding(mesh, P(axis, None)))
    C = jax.device_put(focc.C, NamedSharding(mesh, P()))
    if isinstance(focc, FusedOcc):
        return FusedOcc(rows, C, focc.n, focc.sigma, focc.block)
    return FusedOccBP(rows, C, focc.n, focc.sigma)


def _local_shim(proto, rows_local, C):
    """A same-type structure over THIS shard's rows, for reuse of the
    single-device query helpers with shard-local positions."""
    if isinstance(proto, FusedOcc):
        return FusedOcc(rows_local, C, rows_local.shape[0] * proto.block,
                        proto.sigma, proto.block)
    return FusedOccBP(rows_local, C, rows_local.shape[0] * FusedOccBP.block,
                      proto.sigma)


def _rank_sharded(proto, rows_local, C, c, r, axis: str) -> jnp.ndarray:
    """Full rank(c, r) with rows sharded: masked owner contribution +
    one psum.  r is uint32; non-owned lanes compute garbage on clamped
    local rows and are zeroed before the reduction."""
    block = jnp.uint32(proto.block)
    rps = jnp.uint32(rows_local.shape[0])
    d = lax.axis_index(axis).astype(jnp.uint32)
    b = r // block
    off_rows = d * rps
    own = jnp.logical_and(b >= off_rows, b < off_rows + rps)
    r_loc = r - off_rows * block        # wraps for non-owned lanes (masked)
    rk = rank_batch_f(_local_shim(proto, rows_local, C), c, r_loc)
    return lax.psum(jnp.where(own, rk, jnp.uint32(0)), axis)


def _chain_step_sh(proto, rows_local, C, c_first, consts, r, c, g0,
                   active, axis: str) -> jnp.ndarray:
    """ops/gapdev._chain_step with the rank query routed to the owner
    shard; everything after the psum is replicated arithmetic."""
    rk = _rank_sharded(proto, rows_local, C, c, r, axis)
    cnt_lt = _select_small(c_first, c)
    cu = c.astype(jnp.uint32)
    corr = jnp.logical_and(consts[0] < r, cu == consts[1]).astype(jnp.uint32)
    wrap = jnp.logical_and(cu == consts[2], g0 == 1).astype(jnp.uint32)
    r_new = cnt_lt + rk - corr + wrap
    return jnp.where(active, r_new, r)


def sharded_occ_chain_fn(mesh: Mesh, outer: int, proto, axis: str = AXIS):
    """Chunk program with occ rows AND the gap histogram sharded by rank
    range; lanes replicated.  Mirrors ops/gapdev._chain_chunk_impl."""
    sentinel = jnp.uint32(0xFFFFFFFF)

    def body(rows_sh, C, text_rows, gt_rows, lo0_row, c_first, consts,
             start_rows, afrom, ato, gap_local, r0, k0, samp_idx):
        d = lax.axis_index(axis)
        ghrps = gap_local.shape[0]          # local histogram rows

        def outer_body(r, o):
            kbase = k0 + o * 256
            trow, grow = _read_tg(text_rows, gt_rows, start_rows, lo0_row,
                                  kbase)

            def inner(r, i):
                c, g0 = _col_read(trow, grow, i)
                k = kbase + i
                active = jnp.logical_and(k >= afrom, k < ato)
                r = _chain_step_sh(proto, rows_sh, C, c_first, consts,
                                   r, c, g0, active, axis)
                y = jnp.where(active, r, sentinel)
                return r, y

            r, ys = lax.scan(inner, r, jnp.arange(256, dtype=jnp.int32))
            return r, ys

        r, ys = lax.scan(outer_body, r0, jnp.arange(outer, dtype=jnp.int32))
        yr = ys.reshape(outer * 256, start_rows.shape[0]).reshape(-1)
        # own-range scatter: local row = global row - shard offset;
        # past-end rows (later shards' cells, sentinel) drop.  Negative
        # rows (EARLIER shards' cells) must be remapped out of range
        # explicitly — .at[] wraps negative indices Python-style BEFORE
        # mode="drop" applies, which would corrupt valid cells
        row_l = (yr >> jnp.uint32(8)).astype(jnp.int32) - d * ghrps
        row_l = jnp.where(row_l < 0, jnp.int32(1 << 24), row_l)
        gap_local = gap_local.at[row_l,
                                 (yr & jnp.uint32(255)).astype(jnp.int32)
                                 ].add(1, mode="drop")
        samp = jnp.take_along_axis(
            ys.reshape(outer * 256, start_rows.shape[0]), samp_idx, axis=0)
        return r, gap_local, samp

    rep = P()
    return jax.jit(jax.shard_map(
        body, mesh=mesh,
        in_specs=(P(axis, None), rep, rep, rep, rep, rep, rep,
                  rep, rep, rep, P(axis, None), rep, rep, rep),
        out_specs=(rep, P(axis, None), rep),
        check_vma=False,
    ))


def sharded_occ_anchor_fn(mesh: Mesh, outer: int, proto, axis: str = AXIS):
    """Anchor (contraction) chunk with sharded rows — same stepping, no
    recording.  Mirrors ops/gapdev._anchor_chunk_impl."""

    def body(rows_sh, C, text_rows, gt_rows, lo0_row, c_first, consts,
             start_rows, afrom, ato, r0, k0):
        def outer_body(r, o):
            kbase = k0 + o * 256
            trow, grow = _read_tg(text_rows, gt_rows, start_rows, lo0_row,
                                  kbase)

            def inner(i, r):
                c, g0 = _col_read(trow, grow, i)
                k = kbase + i
                active = jnp.logical_and(k >= afrom, k < ato)
                return _chain_step_sh(proto, rows_sh, C, c_first, consts,
                                      r, c, g0, active, axis)

            return lax.fori_loop(0, 256, inner, r), 0

        r, _ = lax.scan(outer_body, r0, jnp.arange(outer, dtype=jnp.int32))
        return r

    rep = P()
    return jax.jit(jax.shard_map(
        body, mesh=mesh,
        in_specs=(P(axis, None), rep, rep, rep, rep, rep, rep,
                  rep, rep, rep, rep, rep),
        out_specs=rep,
        check_vma=False,
    ))


class ShardedOccGapRunner:
    """Executor for one pair merge whose rank rows + gap histogram exceed
    one device: wraps a DeviceGapRunner, reshards its occ rows by rank
    range, and mirrors the anchor/run_chains interface so the engine's
    downstream (checksum, gap fetch, sample harvest) works unchanged."""

    def __init__(self, mesh: Mesh, runner, axis: str = AXIS):
        self.mesh = mesh
        self.r = runner
        self.axis = axis
        self.D = int(mesh.devices.size)
        self.focc_sh = shard_focc_rows(mesh, runner.focc, axis)
        self._chain_fns = {}
        self._anchor_fns = {}

    # ------------------------------------------------------------ anchor

    def _run_anchor(self, starts: np.ndarray, lbs: np.ndarray,
                    r0_val: int) -> np.ndarray:
        r_ = self.r
        walk_start = starts + lbs
        r_._ensure_gt(int(walk_start.max()) + 1)
        rows, af, at, _ = r_._align(walk_start, lbs)
        r = jnp.full(r_.lane_bucket, np.uint32(r0_val), jnp.uint32)
        saj, afj, atj = jnp.asarray(rows), jnp.asarray(af), jnp.asarray(at)
        max_steps = int(at.max())
        done = 0
        while done < max_steps:
            outer = chunk_outer(max_steps - done)
            if outer not in self._anchor_fns:
                self._anchor_fns[outer] = sharded_occ_anchor_fn(
                    self.mesh, outer, r_.focc, self.axis)
            r = self._anchor_fns[outer](
                self.focc_sh.rows, self.focc_sh.C, r_.text_rows, r_.gt_rows,
                jnp.int32(r_.lo0 // TEXT_BLOCK), r_.c_first, r_.consts,
                saj, afj, atj, r, jnp.int32(done))
            done += outer * 256
        return np.asarray(r)[: len(starts)].astype(np.int64)

    def anchor(self, starts: np.ndarray, lookback: int
               ) -> Tuple[np.ndarray, np.ndarray]:
        r_ = self.r
        lbs = np.minimum(lookback, (r_.e - 2) - starts)
        lbs = np.maximum(lbs, 1)
        lo = self._run_anchor(starts, lbs, 0)
        hi = self._run_anchor(starts, lbs, r_.gap_size)
        return lo, lo == hi

    # ------------------------------------------------------------ chains

    def run_chains(self, starts: np.ndarray, seeds: np.ndarray,
                   lens: np.ndarray, force_int32: bool = False
                   ) -> np.ndarray:
        r_ = self.r
        T = r_.lane_bucket
        grows = _pad_pow2((r_.gap_size + 2 + 255) // 256, lo=4)
        grows += (-grows) % self.D
        assert grows < (1 << 24), \
            "sharded histogram rows must stay below the sentinel row"
        gdt = jnp.int32 if force_int32 else r_.gap_dtype
        gap = jax.device_put(
            jnp.zeros((grows, 256), gdt),
            NamedSharding(self.mesh, P(self.axis, None)))
        r_._ensure_gt(int(starts.max()) + 1)
        rows, af, at, aligned = r_._align(starts, lens)
        rr = np.zeros(T, np.uint32)
        rr[: len(starts)] = seeds
        rj = jnp.asarray(rr)
        saj, afj, atj = jnp.asarray(rows), jnp.asarray(af), jnp.asarray(at)
        max_steps = int(at.max())
        rate = r_.sample_rate
        aligned_abs = aligned + r_.lo0
        phase = (aligned_abs % rate).astype(np.int64) if rate else None
        r_._samples = []
        done = 0
        while done < max_steps:
            outer = chunk_outer(max_steps - done)
            chunklen = outer * 256
            if outer not in self._chain_fns:
                self._chain_fns[outer] = sharded_occ_chain_fn(
                    self.mesh, outer, r_.focc, self.axis)
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
            rj, gap, samp = self._chain_fns[outer](
                self.focc_sh.rows, self.focc_sh.C, r_.text_rows, r_.gt_rows,
                jnp.int32(r_.lo0 // TEXT_BLOCK), r_.c_first, r_.consts,
                saj, afj, atj, gap, rj, jnp.int32(done),
                jnp.asarray(idxc))
            if rate:
                r_._samples.append(
                    (done, np.asarray(samp)[:, : len(starts)], valid))
            done += chunklen
        # runner state mirrors a single-device run: gap is a GLOBAL
        # [grows, 256] array (device-sharded by rank range); checksum,
        # compressed fetch and sample harvest work unchanged on it
        r_.gap = gap
        r_.final_rs = np.asarray(rj)[: len(starts)].astype(np.int64)
        r_._lanes = (starts.copy(), lens.copy(), aligned_abs.copy(),
                     af[: len(starts)].copy(), at[: len(starts)].copy())
        return np.asarray(gap, dtype=np.int64).reshape(-1)[: r_.gap_size + 1]

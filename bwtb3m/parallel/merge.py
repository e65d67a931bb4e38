"""Mesh-sharded gap chains — the multi-chip merge engine path.

The reference parallelizes one pair merge by splitting the left block's
suffix ranges over threads (SURVEY.md section 2.3.3, arXiv:1604.06687
parallel section). The device mapping shards the CHAIN LANES over the mesh:
every device runs the same per-step program (ops/gapdev.py
``_chain_chunk_impl``) on its slice of the lanes against a replicated
rank structure, accumulating a per-device partial gap histogram; the
histograms are summed at the end (one reduction, not one per step).

Replicating the occ rows per device is the right trade below ~2^31-symbol
right regions (they fit one device comfortably); sharding the occ rows by
rank range — for regions beyond one device's HBM — would route each
chain's rank query through the owner shard and is the documented next
step (ROADMAP).

Pair merges at the same tree level are independent, so a pod runs one
pair per device-group with NO collectives at all; the lane-sharded path
here is the intra-pair speedup and the shape the dryrun validates.
"""

from __future__ import annotations

from functools import partial
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from ..ops.gapdev import _chain_chunk_impl, chunk_outer
from .mesh import AXIS


def sharded_chain_chunk_fn(mesh: Mesh, outer: int, axis: str = AXIS):
    """Build the shard_mapped chunk program: lanes sharded, occ/text/gt
    replicated, per-shard partial gap histograms returned stacked."""

    def body(focc, text_rows, gt_rows, lo0_row, c_first, consts,
             start_rows, afrom, ato, gap, r0, k0, samp_idx):
        r, g, samp = _chain_chunk_impl(
            outer, focc, text_rows, gt_rows, lo0_row, c_first, consts,
            start_rows, afrom, ato, gap[0], r0, k0, samp_idx)
        return r, g[None], samp

    rep = P()
    lane = P(axis)
    return jax.jit(jax.shard_map(
        body, mesh=mesh,
        in_specs=(rep, rep, rep, rep, rep, rep,
                  lane, lane, lane, P(axis, None, None),
                  lane, rep, P(None, axis)),
        out_specs=(lane, P(axis, None, None), P(None, axis)),
    ))


class ShardedGapRunner:
    """Drop-in chain executor for one pair merge with lanes sharded over a
    mesh. Interface mirrors the single-device DeviceGapRunner.run_chains
    essentials; used by the multi-chip dryrun and the pod path."""

    def __init__(self, mesh: Mesh, runner, axis: str = AXIS):
        self.mesh = mesh
        self.r = runner  # a DeviceGapRunner carrying occ/text/gt state
        self.axis = axis
        self._fns = {}

    def run_chains(self, starts: np.ndarray, seeds: np.ndarray,
                   lens: np.ndarray) -> np.ndarray:
        """Drop-in for DeviceGapRunner.run_chains with the chain lanes
        sharded over the mesh: leaves the summed gap histogram, final
        lane ranks and harvested samples on the wrapped runner (so
        gap_checksum / fetch_gap_compressed / harvest_samples all work
        unchanged), and also returns the histogram as int64 for the
        dryrun's bit-identity check."""
        from ..ops.gapdev import _pad_pow2
        r = self.r
        D = self.mesh.devices.size
        T = r.lane_bucket
        assert T % D == 0
        r._ensure_gt(int(starts.max()) + 1)
        rows, af, at, aligned = r._align(starts, lens)
        grows = _pad_pow2((r.gap_size + 2 + 255) // 256, lo=4)
        gap = jnp.zeros((D, grows, 256), jnp.int32)
        rr = np.zeros(T, np.uint32)
        rr[: len(starts)] = seeds
        rj = jnp.asarray(rr)
        saj, afj, atj = jnp.asarray(rows), jnp.asarray(af), jnp.asarray(at)
        max_steps = int(at.max())
        rate = r.sample_rate
        aligned_abs = aligned + r.lo0
        phase = (aligned_abs % rate).astype(np.int64) if rate else None
        r._samples = []
        done = 0
        while done < max_steps:
            outer = chunk_outer(max_steps - done)
            chunklen = outer * 256
            if outer not in self._fns:
                self._fns[outer] = sharded_chain_chunk_fn(
                    self.mesh, outer, self.axis)
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
            rj, gap, samp = self._fns[outer](
                r.focc, r.text_rows, r.gt_rows,
                jnp.int32(r.lo0 // 256), r.c_first, r.consts,
                saj, afj, atj, gap, rj, jnp.int32(done),
                jnp.asarray(idxc))
            if rate:
                r._samples.append(
                    (done, np.asarray(samp)[:, : len(starts)], valid))
            done += chunklen
        # one reduction at the end (not one per step); runner state now
        # mirrors a single-device run exactly
        r.gap = jnp.sum(gap, axis=0)
        r.final_rs = np.asarray(rj)[: len(starts)].astype(np.int64)
        r._lanes = (starts.copy(), lens.copy(), aligned_abs.copy(),
                    af[: len(starts)].copy(), at[: len(starts)].copy())
        return np.asarray(r.gap, dtype=np.int64).reshape(-1)[: r.gap_size + 1]


# ---------------------------------------------------------------------------
# batched-level merges over the mesh: independent same-level pair merges
# distributed across devices (SURVEY.md section 2.3.3 merge-tree
# parallelism; round-3 ROADMAP "Still open" #1).  The batched level's lane
# population is ordered by merge, so sharding the LANE axis assigns whole
# merges (up to one boundary merge per cut) to device groups — each device
# runs its merges' chains against the replicated concatenated rank rows
# with zero per-step collectives; the per-device partial histograms sum
# once at the end (int32 partials: exact, no u16 rerun needed).
# ---------------------------------------------------------------------------

def sharded_batched_chain_fn(mesh: Mesh, outer: int, axis: str = AXIS):
    from ..ops.gapbatch import _chain_chunk_mk_impl

    def body(focc, text_rows, gt_rows, l0r, gtb, gtl, cb, isg, syb, syl,
             rows, af, at, gap, r0, k0, samp_idx):
        r, g, samp = _chain_chunk_mk_impl(
            outer, focc, text_rows, gt_rows, l0r, gtb, gtl, cb, isg,
            syb, syl, rows, af, at, gap[0], r0, k0, samp_idx)
        return r, g[None], samp

    rep = P()
    lane = P(axis)
    return jax.jit(jax.shard_map(
        body, mesh=mesh,
        in_specs=(rep, rep, rep, lane, lane, lane, P(axis, None), lane,
                  lane, lane, lane, lane, lane, P(axis, None, None),
                  lane, rep, P(None, axis)),
        out_specs=(lane, P(axis, None, None), P(None, axis)),
    ))


def sharded_batched_anchor_fn(mesh: Mesh, outer: int, axis: str = AXIS):
    from ..ops.gapbatch import _anchor_chunk_mk_impl

    def body(focc, text_rows, gt_rows, l0r, gtb, gtl, cb, isg, syb, syl,
             rows, af, at, r0, k0):
        return _anchor_chunk_mk_impl(
            outer, focc, text_rows, gt_rows, l0r, gtb, gtl, cb, isg,
            syb, syl, rows, af, at, r0, k0)

    rep = P()
    lane = P(axis)
    return jax.jit(jax.shard_map(
        body, mesh=mesh,
        in_specs=(rep, rep, rep, lane, lane, lane, P(axis, None), lane,
                  lane, lane, lane, lane, lane, lane, rep),
        out_specs=lane,
    ))

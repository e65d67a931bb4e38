"""Distributed multi-key sort across a device mesh: block merge-split
odd-even transposition.

This is the communication core of the sharded suffix sorter — the device
replacement for the reference's external-memory merge sorts
(``sorting::MergingReadBack`` k-way merges and ``ParallelExternalRadixSort``,
SURVEY.md section 2.2). Design constraints that picked this algorithm:

* every exchange moves exactly K elements between static partner pairs
  (``lax.ppermute``), so it compiles for any backend — XLA:CPU has no
  ragged-all-to-all, and static communication keeps the while_loop-able
  doubling graph small;
* blocks stay locally sorted at all times; a compare-exchange between
  partners is "merge-split": sort the 2K union, low partner keeps the lower
  half. By the 0-1 principle, D odd-even rounds over D blocks sort globally.

For large D a bitonic block network (log^2 D rounds) or a sample-sort
with ``ragged_all_to_all`` drops the round count; the odd-even variant
over ``ppermute`` is what runs.

All functions here run *inside* ``shard_map`` over a 1-D mesh axis.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import jax
import jax.numpy as jnp
from jax import lax


def _partner_table(D: int, parity: int):
    """partner(i) for one odd-even round; identity where idle."""
    part = list(range(D))
    start = 0 if parity == 0 else 1
    for i in range(start, D - 1, 2):
        part[i], part[i + 1] = i + 1, i
    return part


def merge_split_round(
    arrs: Tuple[jnp.ndarray, ...], parity: int, D: int, axis: str
) -> Tuple[jnp.ndarray, ...]:
    """One odd-even compare-exchange round over locally sorted blocks."""
    s = lax.axis_index(axis)
    partner = _partner_table(D, parity)
    perm = [(i, partner[i]) for i in range(D)]
    received = tuple(lax.ppermute(a, axis, perm) for a in arrs)
    merged = lax.sort(
        tuple(jnp.concatenate([a, r]) for a, r in zip(arrs, received)),
        num_keys=len(arrs),
        is_stable=False,  # composite keys are unique by construction
    )
    K = arrs[0].shape[0]
    partner_vec = jnp.asarray(partner, dtype=jnp.int32)
    my_partner = partner_vec[s]
    is_low = s < my_partner
    is_idle = my_partner == s
    out = []
    for a, m in zip(arrs, merged):
        low, high = m[:K], m[K:]
        picked = jnp.where(is_low, low, high)
        out.append(jnp.where(is_idle, a, picked))
    return tuple(out)


def _bitonic_merge_split(
    arrs: Tuple[jnp.ndarray, ...], j: int, k: int, D: int, axis: str
) -> Tuple[jnp.ndarray, ...]:
    """One bitonic comparator step: shard s exchanges with s^j; the pair
    keeps (low, high) halves oriented by bit k of the lower index."""
    s = lax.axis_index(axis)
    perm = [(i, i ^ j) for i in range(D)]
    received = tuple(lax.ppermute(a, axis, perm) for a in arrs)
    merged = lax.sort(
        tuple(jnp.concatenate([a, r]) for a, r in zip(arrs, received)),
        num_keys=len(arrs),
        is_stable=False,
    )
    K = arrs[0].shape[0]
    partner = s ^ j
    ascending = (s & k) == 0
    keep_low = (s < partner) == ascending
    out = []
    for m in merged:
        out.append(jnp.where(keep_low, m[:K], m[K:]))
    return tuple(out)


def distributed_sort(
    arrs: Sequence[jnp.ndarray], num_keys: int, D: int, axis: str
) -> Tuple[jnp.ndarray, ...]:
    """Globally sort sharded arrays by their first ``num_keys`` components.

    ``arrs``: per-shard views [K] inside shard_map. The composite key
    (including trailing value columns used as tiebreak) must be globally
    unique for a deterministic result. Returns per-shard views of the
    globally sorted arrays (shard s holds global sorted positions
    [s*K, (s+1)*K)).

    Power-of-two meshes use a bitonic block network (log^2 D merge-split
    steps); other sizes fall back to odd-even transposition (D steps).
    Both are valid by the 0-1 principle over sorted blocks with
    merge-split comparators.
    """
    arrs = tuple(arrs)
    # local pre-sort establishes the invariant
    arrs = lax.sort(arrs, num_keys=num_keys, is_stable=False)
    if D == 1:
        return arrs
    if D & (D - 1) == 0:
        k = 2
        while k <= D:
            j = k // 2
            while j >= 1:
                arrs = _bitonic_merge_split(arrs, j, k, D, axis)
                j //= 2
            k *= 2
        return arrs
    for t in range(D):
        arrs = merge_split_round(arrs, t % 2, D, axis)
    return arrs


def exclusive_shard_offset(local_total: jnp.ndarray, D: int, axis: str) -> jnp.ndarray:
    """Sum of ``local_total`` over shards with lower index (scalar)."""
    s = lax.axis_index(axis)
    totals = lax.all_gather(local_total, axis)  # [D]
    return jnp.sum(jnp.where(jnp.arange(D) < s, totals, 0))


def fetch_prev_shard_last(x: jnp.ndarray, D: int, axis: str) -> jnp.ndarray:
    """Each shard receives the last element of the previous shard
    (shard 0 receives shard D-1's; callers mask it)."""
    perm = [(i, (i + 1) % D) for i in range(D)]
    return lax.ppermute(x[-1:], axis, perm)[0]

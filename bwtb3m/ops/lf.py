"""Batched LF mapping and backward search steps.

Device equivalents of the reference's LF layer
(``lf::ImpCompactHuffmanWaveletLF::extendedLF`` used by the checkbwt walk,
/root/reference/src/checkbwt.cpp:202; ``step(sym, lo, hi)`` backward search,
/root/reference/src/probeScanDna.cpp:100-107). All entry points operate on
batches of lanes so thousands of independent walks keep the chip busy —
the scaled-up version of the interleaved-walk design measured by
/root/reference/src/bwttestdecodespeed.cpp:67-97.
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp
from jax import lax

from .rank import OccTable, rank_batch


def lf_step_batch(occt, r: jnp.ndarray) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Extended LF for a batch of ranks: returns (sym, r') with
    r' = C[sym] + rank(sym, r) — one backwards step of every lane's walk.

    Fused formulation: ONE block-row gather feeds symbol extraction, the
    in-block count, and (with a second occ-row gather) the checkpoint and
    C lookups, all via compare-mask selects instead of element gathers."""
    from .rank import _select_col
    from .rank_packed import PackedOccTable, lf_step_batch_packed
    if isinstance(occt, PackedOccTable):
        return lf_step_batch_packed(occt, r)
    block = occt.block
    b = r // block
    bsafe = jnp.minimum(b, occt.bwt_blocks.shape[0] - 1)
    rows = jnp.take(occt.bwt_blocks, bsafe, axis=0)   # [B, block]
    off = r - b * block
    sym = _select_col(rows, off)
    occ_rows = jnp.take(occt.occ, b, axis=0)          # [B, sigma]
    base = _select_col(occ_rows, sym)
    col = lax.broadcasted_iota(jnp.int32, rows.shape, 1)
    inblk = jnp.sum(
        jnp.logical_and(rows == sym[:, None], col < off[:, None]).astype(jnp.int32),
        axis=1)
    csel = _select_col(
        jnp.broadcast_to(occt.C[None, : occt.sigma], (r.shape[0], occt.sigma)),
        sym)
    return sym, csel + base + inblk


def backward_search_step(
    occt, c: jnp.ndarray, lo: jnp.ndarray, hi: jnp.ndarray
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Batched FM backward-search step: interval of suffixes prefixed by
    c · current-pattern. lo/hi are half-open rank intervals."""
    from .rank import _select_col
    csel = _select_col(
        jnp.broadcast_to(occt.C[None, : occt.sigma], (c.shape[0], occt.sigma)),
        c)
    lo2 = csel + rank_batch(occt, c, lo)
    hi2 = csel + rank_batch(occt, c, hi)
    return lo2, hi2


def lf_walk(
    occt: OccTable, r0: jnp.ndarray, steps: int, record_every: int = 0
):
    """Walk LF backwards ``steps`` times from each lane's starting rank.

    Returns final ranks [B] and, when record_every > 0, the recorded
    (step, rank) trace [B, steps//record_every].
    """
    B = r0.shape[0]

    if record_every:
        ntr = steps // record_every

        def body(i, carry):
            r, trace = carry
            _sym, r2 = lf_step_batch(occt, r)
            ti = i // record_every
            write = (i % record_every) == 0
            trace = lax.cond(
                write,
                lambda t: lax.dynamic_update_index_in_dim(t, r, ti, axis=1),
                lambda t: t,
                trace,
            )
            return (r2, trace)

        trace0 = jnp.zeros((B, max(1, ntr)), jnp.int32)
        r, trace = lax.fori_loop(0, steps, body, (r0, trace0))
        return r, trace

    def body(_i, r):
        _sym, r2 = lf_step_batch(occt, r)
        return r2

    return lax.fori_loop(0, steps, body, r0), None

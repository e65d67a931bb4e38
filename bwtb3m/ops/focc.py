"""Fused occ+BWT rank structure — one row gather per rank query / LF step.

Device row gathers are the latency unit of every walk kernel: the plain OccTable
needs TWO row gathers per step (occ checkpoint row + bwt block row) plus an
int32-resident BWT (4 B/symbol).  This structure fuses both into one int8
row per block:

    row[b] = [ 256 BWT symbols (int8) | occ counts as 4 little-endian
               bytes per symbol | zero pad to a 128 lane multiple ]

so a batched rank(c, i) is ONE [B, ROWW] int8 row gather followed by pure
VPU work (mask-select the 4 count bytes, reassemble uint32, compare-count
the in-block symbols).  Counts are uint32 end-to-end, so texts up to
2^32-1 symbols are supported — the int32 OccTable's 2^31 ceiling does
not apply.  Memory: ~1.5 B/symbol at sigma=5
(vs 4.2 B/symbol for OccTable), which is what lets a 1.6 G-symbol merge
side stay device-resident.

Reference roles served: ``lf::ImpCompactHuffmanWaveletLF::extendedLF``
(/root/reference/src/checkbwt.cpp:202), ``rank::DNARank`` occ tables
(/root/reference/src/bwttodnarank.cpp:34), and the merge engine's rank
oracle (SURVEY.md section 3.1 HOT LOOP #2).
"""

from __future__ import annotations

from functools import partial
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax, tree_util

BLOCK = 256


def _row_width(sigma: int, block: int) -> int:
    w = block + 4 * sigma
    return ((w + 127) // 128) * 128


class FusedOcc:
    """Fused rank rows + C array. Registered as a pytree with static
    (n, sigma, block) so jitted consumers specialize on shape. ``rows``
    may be padded with extra zero rows (shape-bucketing for compile
    reuse); queries never touch them because i <= n."""

    def __init__(self, rows, C, n, sigma, block):
        self.rows = rows      # int8 [nb_pad, ROWW]
        self.C = C            # uint32 [sigma+1]
        self.n = n
        self.sigma = sigma
        self.block = block

    def tree_flatten(self):
        return (self.rows, self.C), (self.n, self.sigma, self.block)

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children, *aux)


tree_util.register_pytree_node(
    FusedOcc, FusedOcc.tree_flatten, FusedOcc.tree_unflatten
)


def _pad_rows(nb: int) -> int:
    """Bucket row counts so reruns at nearby sizes reuse compiled graphs
    (each distinct occ shape is one more compile)."""
    if nb <= 1024:
        return 1024
    p = 1 << (nb - 1).bit_length()
    # quarter-power-of-two buckets: <= 4 shapes per octave
    for frac in (p // 2 + p // 8, p // 2 + p // 4, p // 2 + 3 * p // 8, p):
        if nb <= frac:
            return frac
    return p


@partial(jax.jit, static_argnums=(1, 2, 3))
def _build_focc_jax(bwt: jnp.ndarray, sigma: int, block: int,
                    nb_pad: int) -> FusedOcc:
    n = bwt.shape[0]
    nb = (n + block - 1) // block
    pad = nb * block - n
    # count on int32 with pad = -1 (outside 0..255, never counted); the
    # stored int8 rows keep only the bit pattern — queries mask back with
    # & 0xFF, so symbols up to 255 are handled (bytestream alphabets)
    b32 = bwt.astype(jnp.int32) & 0xFF
    if pad:
        b32 = jnp.concatenate([b32, jnp.full((pad,), -1, jnp.int32)])
    blocks32 = b32.reshape(nb, block)
    blocks = blocks32.astype(jnp.int8)
    sym_ids = lax.broadcasted_iota(jnp.int32, (1, 1, sigma), 2)
    per_block = jnp.sum(
        (blocks32[:, :, None] == sym_ids).astype(jnp.uint32),
        axis=1)                                   # [nb, sigma]
    cum = jnp.cumsum(per_block, axis=0, dtype=jnp.uint32)
    # nb+1 checkpoint rows: a query at i == n (e.g. the upper anchor bound
    # r = |M|) reads row nb when n % block == 0, which must carry the
    # total counts, not padding
    occ = jnp.concatenate(
        [jnp.zeros((1, sigma), jnp.uint32), cum], axis=0)  # [nb+1] exclusive
    total = cum[-1]
    C = jnp.concatenate(
        [jnp.zeros(1, jnp.uint32), jnp.cumsum(total, dtype=jnp.uint32)])
    # occ counts -> 4 little-endian bytes per symbol: col block + 4c + k
    shifts = jnp.array([0, 8, 16, 24], jnp.uint32)
    occ_bytes = ((occ[:, :, None] >> shifts[None, None, :]) & 0xFF).astype(
        jnp.int8).reshape(nb + 1, 4 * sigma)
    roww = _row_width(sigma, block)
    rows = jnp.zeros((nb_pad, roww), jnp.int8)
    rows = rows.at[:nb, :block].set(blocks)
    rows = rows.at[: nb + 1, block : block + 4 * sigma].set(occ_bytes)
    return FusedOcc(rows, C, n, sigma, block)


def build_focc(bwt, sigma: int, block: int = BLOCK,
               pad_shape: bool = True):
    """Build the fused rank structure on device from an int8/int32 BWT
    array. For sigma <= 8 this returns the bit-plane popcount variant
    (ops/focc_bp.py — 3x smaller rows, ~10x less VPU work per query);
    wider alphabets get the byte-row FusedOcc. Every query helper below
    dispatches on the structure type, so consumers are agnostic.
    Set BWTB3M_FOCC=legacy to force the byte-row structure (A/B bench)."""
    import os
    if sigma > 256:
        raise ValueError("FusedOcc stores symbols as bytes (sigma <= 256); "
                         "use ops/rank.py OccTable for wider alphabets")
    bwt = jnp.asarray(bwt)
    n = int(bwt.shape[0])
    if (sigma <= 8 and block == BLOCK
            and os.environ.get("BWTB3M_FOCC") != "legacy"):
        from .focc_bp import build_focc_bp
        return build_focc_bp(bwt, int(sigma), pad_shape)
    nb = max(1, (n + block - 1) // block)
    nb_pad = _pad_rows(nb + 1) if pad_shape else nb + 1
    return _build_focc_jax(bwt, int(sigma), int(block), int(nb_pad))


# ------------------------------------------------------------------ queries
#
# All queries take uint32 positions/ranks i in [0, n] and return uint32.
# Every helper uses only row gathers + compare-mask selects (element
# gathers cost one dependent memory access per lane).

def _gather_rows(focc: FusedOcc, i: jnp.ndarray) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Row gather for positions i: returns (rows [B, ROWW] int8, off uint32)."""
    b = (i // jnp.uint32(focc.block)).astype(jnp.int32)
    b = jnp.minimum(b, focc.rows.shape[0] - 1)
    rows = jnp.take(focc.rows, b, axis=0)
    off = i - (b.astype(jnp.uint32) * jnp.uint32(focc.block))
    return rows, off


def _occ_base(focc: FusedOcc, rows: jnp.ndarray, c: jnp.ndarray) -> jnp.ndarray:
    """Reassemble the uint32 occ checkpoint for symbol c[j] from row j's
    count bytes via 4 narrow mask-selects."""
    block, sigma = focc.block, focc.sigma
    cnt = rows[:, block : block + 4 * sigma].astype(jnp.int32) & 0xFF
    col = lax.broadcasted_iota(jnp.int32, cnt.shape, 1)
    base = jnp.zeros(rows.shape[0], jnp.uint32)
    for k in range(4):
        sel = jnp.sum(jnp.where(col == (4 * c + k)[:, None], cnt, 0),
                      axis=1).astype(jnp.uint32)
        base = base | (sel << jnp.uint32(8 * k))
    return base


def _inblock_count(focc: FusedOcc, rows: jnp.ndarray, c: jnp.ndarray,
                   off: jnp.ndarray) -> jnp.ndarray:
    syms = rows[:, : focc.block]
    col = lax.broadcasted_iota(jnp.uint32, syms.shape, 1)
    hit = jnp.logical_and(syms == c.astype(jnp.int8)[:, None],
                          col < off[:, None])
    return jnp.sum(hit.astype(jnp.uint32), axis=1)


def _symbol_at(focc: FusedOcc, rows: jnp.ndarray, off: jnp.ndarray) -> jnp.ndarray:
    syms = rows[:, : focc.block]
    col = lax.broadcasted_iota(jnp.uint32, syms.shape, 1)
    # & 0xFF: rows are int8 bit patterns; symbols >= 128 (bytestream
    # alphabets) must not sign-extend
    return jnp.sum(jnp.where(col == off[:, None],
                             syms.astype(jnp.int32) & 0xFF, 0), axis=1)


def _select_c(focc: FusedOcc, c: jnp.ndarray) -> jnp.ndarray:
    ctab = jnp.broadcast_to(focc.C[None, : focc.sigma],
                            (c.shape[0], focc.sigma))
    col = lax.broadcasted_iota(jnp.int32, ctab.shape, 1)
    return jnp.sum(jnp.where(col == c[:, None], ctab, jnp.uint32(0)), axis=1)


def rank_batch_f(focc, c: jnp.ndarray, i: jnp.ndarray) -> jnp.ndarray:
    """Batched rank: occurrences of c[j] (int32) in bwt[0:i[j]) (uint32)."""
    if not isinstance(focc, FusedOcc):
        from .focc_bp import rank_batch_bp
        return rank_batch_bp(focc, c, i)
    i = i.astype(jnp.uint32)
    rows, off = _gather_rows(focc, i)
    return _occ_base(focc, rows, c) + _inblock_count(focc, rows, c, off)


def access_batch_f(focc, i: jnp.ndarray) -> jnp.ndarray:
    """Batched bwt[i] (int32)."""
    if not isinstance(focc, FusedOcc):
        from .focc_bp import access_batch_bp
        return access_batch_bp(focc, i)
    rows, off = _gather_rows(focc, i.astype(jnp.uint32))
    return _symbol_at(focc, rows, off)


def lf_step_batch_f(focc, r: jnp.ndarray
                    ) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Extended LF for a batch of uint32 ranks: (sym int32, r' uint32) with
    r' = C[sym] + rank(sym, r) — ONE row gather serves the symbol read, the
    checkpoint bytes and the in-block count."""
    if not isinstance(focc, FusedOcc):
        from .focc_bp import lf_step_batch_bp
        return lf_step_batch_bp(focc, r)
    r = r.astype(jnp.uint32)
    rows, off = _gather_rows(focc, r)
    sym = _symbol_at(focc, rows, off)
    base = _occ_base(focc, rows, sym)
    inblk = _inblock_count(focc, rows, sym, off)
    return sym, _select_c(focc, sym) + base + inblk


def backward_step_f(focc, c: jnp.ndarray, lo: jnp.ndarray,
                    hi: jnp.ndarray) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Batched FM backward-search step on uint32 intervals."""
    if not isinstance(focc, FusedOcc):
        from .focc_bp import backward_step_bp
        return backward_step_bp(focc, c, lo, hi)
    csel = _select_c(focc, c)
    return (csel + rank_batch_f(focc, c, lo),
            csel + rank_batch_f(focc, c, hi))

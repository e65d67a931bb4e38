"""Bit-plane-packed occ tables — the bandwidth-optimal rank structure.

The plain ``OccTable`` gathers a 128-symbol int32 row (512 B) per rank
query; this variant packs each 128-symbol block into ceil(log2 sigma)
bit-planes of four u32 words each (32 B per query for DNA), answering the
in-block count with XOR/AND masks + ``lax.population_count``. This is the
device shape of the reference's cache-line-aligned occ superblocks
(``rank::DNARank``, /root/reference/src/bwttodnarank.cpp) and the path to
the north star's memory-bandwidth-limited gap kernel.
"""

from __future__ import annotations

import math
from functools import partial
from typing import Tuple

import jax
import jax.numpy as jnp
from jax import lax, tree_util

BLOCK = 128
_WPB = BLOCK // 32  # u32 words per block per plane


class PackedOccTable:
    """Pytree: planes u32 [nb, P, WPB], occ i32 [nb+1, sigma], C i32."""

    def __init__(self, planes, occ, C, n, sigma, nplanes):
        self.planes = planes
        self.occ = occ
        self.C = C
        self.n = n
        self.sigma = sigma
        self.nplanes = nplanes
        self.block = BLOCK

    def tree_flatten(self):
        return (self.planes, self.occ, self.C), (self.n, self.sigma, self.nplanes)

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children, *aux)


tree_util.register_pytree_node(
    PackedOccTable, PackedOccTable.tree_flatten, PackedOccTable.tree_unflatten
)


@partial(jax.jit, static_argnums=(1, 2))
def _build_packed_jax(bwt: jnp.ndarray, sigma: int, nplanes: int) -> PackedOccTable:
    n = bwt.shape[0]
    nb = (n + BLOCK - 1) // BLOCK
    pad = nb * BLOCK - n
    # pad with zeros: rank masks exclude padded positions (i <= n always)
    padded = jnp.concatenate([bwt.astype(jnp.uint32),
                              jnp.zeros((pad,), jnp.uint32)]) if pad else bwt.astype(jnp.uint32)
    blocks = padded.reshape(nb, BLOCK)
    # per-block symbol counts via one-hot (over the real symbols only)
    sym_ids = lax.broadcasted_iota(jnp.uint32, (1, 1, sigma), 2)
    real = (lax.broadcasted_iota(jnp.int32, (nb, BLOCK), 0) * BLOCK
            + lax.broadcasted_iota(jnp.int32, (nb, BLOCK), 1)) < n
    per_block = jnp.sum(
        jnp.logical_and(blocks[:, :, None] == sym_ids,
                        real[:, :, None]).astype(jnp.int32), axis=1)
    occ = jnp.concatenate(
        [jnp.zeros((1, sigma), jnp.int32), jnp.cumsum(per_block, axis=0)], axis=0)
    total = occ[-1]
    C = jnp.concatenate([jnp.zeros(1, jnp.int32), jnp.cumsum(total)])
    # bit-planes: plane j word w of block b packs bit j of symbols
    # [w*32, (w+1)*32), LSB = first symbol
    lanes = blocks.reshape(nb, _WPB, 32)  # [nb, w, 32]
    weights = (jnp.uint32(1) << lax.broadcasted_iota(jnp.uint32, (1, 1, 32), 2))
    planes = []
    for j in range(nplanes):
        bits = (lanes >> jnp.uint32(j)) & jnp.uint32(1)
        planes.append(jnp.sum(bits * weights, axis=2, dtype=jnp.uint32))
    planes = jnp.stack(planes, axis=1)  # [nb, P, WPB]
    return PackedOccTable(planes, occ, C, n, sigma, nplanes)


def build_occ_packed(bwt, sigma: int) -> PackedOccTable:
    nplanes = max(1, math.ceil(math.log2(max(2, sigma))))
    return _build_packed_jax(jnp.asarray(bwt, jnp.int32), int(sigma), nplanes)


def _match_words(occt: PackedOccTable, words: jnp.ndarray, c: jnp.ndarray) -> jnp.ndarray:
    """words: u32 [B, P, W]; c: i32 [B] -> u32 [B, W] with 1-bits where
    the packed symbol equals c."""
    cu = c.astype(jnp.uint32)
    match = jnp.full(words.shape[::2], 0xFFFFFFFF, jnp.uint32)  # [B, W]
    for j in range(occt.nplanes):
        cbit = (cu >> jnp.uint32(j)) & jnp.uint32(1)
        flip = jnp.where(cbit == 1, jnp.uint32(0), jnp.uint32(0xFFFFFFFF))
        match = match & (words[:, j, :] ^ flip[:, None])
    return match


def _prefix_mask(off: jnp.ndarray, W: int) -> jnp.ndarray:
    """u32 [B, W] masking bit positions < off within the block."""
    word_base = lax.broadcasted_iota(jnp.int32, (1, W), 1) * 32
    rel = jnp.clip(off[:, None] - word_base, 0, 32).astype(jnp.uint32)
    full = rel >= 32
    mask = jnp.where(
        full, jnp.uint32(0xFFFFFFFF),
        (jnp.uint32(1) << rel) - jnp.uint32(1))
    return mask


def _select_col_i32(rows: jnp.ndarray, idx: jnp.ndarray) -> jnp.ndarray:
    col = lax.broadcasted_iota(jnp.int32, rows.shape, 1)
    return jnp.sum(jnp.where(col == idx[:, None], rows,
                             jnp.zeros_like(rows)), axis=1)


def rank_batch_packed(occt: PackedOccTable, c: jnp.ndarray, i: jnp.ndarray) -> jnp.ndarray:
    b = i // BLOCK
    bsafe = jnp.minimum(b, occt.planes.shape[0] - 1)
    words = occt.planes[bsafe]            # [B, P, W] row gather
    occ_rows = jnp.take(occt.occ, b, axis=0)  # [B, sigma] row gather
    base = _select_col_i32(occ_rows, c)   # no element gather (latency floor)
    match = _match_words(occt, words, c)  # [B, W]
    mask = _prefix_mask(i - b * BLOCK, _WPB)
    cnt = jnp.sum(lax.population_count(match & mask), axis=1).astype(jnp.int32)
    return base + cnt


def _extract_sym(occt: PackedOccTable, words: jnp.ndarray,
                 off: jnp.ndarray) -> jnp.ndarray:
    """Symbol at in-block offset `off` from plane words [B, P, W] via
    mask-select (no element gathers)."""
    w = off // 32
    bit = (off % 32).astype(jnp.uint32)
    col = lax.broadcasted_iota(jnp.int32, (words.shape[0], _WPB), 1)
    wmask = (col == w[:, None])
    sym = jnp.zeros(off.shape[0], jnp.int32)
    for j in range(occt.nplanes):
        wordj = jnp.sum(jnp.where(wmask, words[:, j, :],
                                  jnp.zeros_like(words[:, j, :])), axis=1)
        sym = sym | (((wordj >> bit) & jnp.uint32(1)).astype(jnp.int32) << j)
    return sym


def access_batch_packed(occt: PackedOccTable, i: jnp.ndarray) -> jnp.ndarray:
    b = i // BLOCK
    bsafe = jnp.minimum(b, occt.planes.shape[0] - 1)
    words = occt.planes[bsafe]            # [B, P, W] row gather
    return _extract_sym(occt, words, i - b * BLOCK)


def lf_step_batch_packed(occt: PackedOccTable, r: jnp.ndarray) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Fused: one plane-row gather + one occ-row gather per step."""
    b = r // BLOCK
    bsafe = jnp.minimum(b, occt.planes.shape[0] - 1)
    words = occt.planes[bsafe]            # [B, P, W]
    off = r - b * BLOCK
    sym = _extract_sym(occt, words, off)
    occ_rows = jnp.take(occt.occ, b, axis=0)
    base = _select_col_i32(occ_rows, sym)
    match = _match_words(occt, words, sym)
    mask = _prefix_mask(off, _WPB)
    cnt = jnp.sum(lax.population_count(match & mask), axis=1).astype(jnp.int32)
    csel = _select_col_i32(
        jnp.broadcast_to(occt.C[None, : occt.sigma], (r.shape[0], occt.sigma)),
        sym)
    return sym, csel + base + cnt

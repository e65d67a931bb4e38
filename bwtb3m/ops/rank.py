"""Occ-table rank structure — the device-side rank oracle.

Device equivalent of the reference's Huffman-shaped wavelet tree /
``DNARank`` occ tables (rank oracle of the merge engine and every LF walk:
``ImpCompactHuffmanWaveletLF``, /root/reference/src/checkbwt.cpp:165-166;
``rank::DNARank``, /root/reference/src/bwttodnarank.cpp:34). Design:
checkpointed symbol counts every BLOCK symbols in device memory plus an in-block scan,
evaluated for *batches* of queries at once — the device analog of the
interleaved-walk ILP experiment in
/root/reference/src/bwttestdecodespeed.cpp:67-97, scaled to thousands of
concurrent walks.

Layout: ``occ[b, c]`` = count of symbol c in bwt[0 : b*BLOCK], int32
[nb+1, sigma]; the bwt itself stays resident as int32 (a packed bit-plane
variant is the planned Pallas upgrade). The alphabet must be dense
(0..sigma-1); engine code maps sparse alphabets densely first.
"""

from __future__ import annotations

from functools import partial
import jax
import jax.numpy as jnp
from jax import lax, tree_util

DEFAULT_BLOCK = 128


class OccTable:
    """Checkpointed occ counts + resident BWT. Registered as a pytree with
    (n, sigma, block) static so jitted consumers specialize on shape."""

    def __init__(self, bwt_blocks, occ, C, n, sigma, block):
        self.bwt_blocks = bwt_blocks  # int32 [nb, block]
        self.occ = occ                # int32 [nb+1, sigma]
        self.C = C                    # int32 [sigma+1]
        self.n = n
        self.sigma = sigma
        self.block = block

    def tree_flatten(self):
        return (self.bwt_blocks, self.occ, self.C), (self.n, self.sigma, self.block)

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children, *aux)


tree_util.register_pytree_node(
    OccTable, OccTable.tree_flatten, OccTable.tree_unflatten
)


@partial(jax.jit, static_argnums=(1, 2))
def _build_occ_jax(bwt: jnp.ndarray, sigma: int, block: int) -> OccTable:
    n = bwt.shape[0]
    nb = (n + block - 1) // block
    pad = nb * block - n
    padded = jnp.concatenate(
        [bwt.astype(jnp.int32), jnp.full((pad,), -1, jnp.int32)]
    ) if pad else bwt.astype(jnp.int32)
    blocks = padded.reshape(nb, block)
    sym_ids = lax.broadcasted_iota(jnp.int32, (1, 1, sigma), 2)
    per_block = jnp.sum(
        (blocks[:, :, None] == sym_ids).astype(jnp.int32), axis=1
    )  # [nb, sigma]
    occ = jnp.concatenate(
        [jnp.zeros((1, sigma), jnp.int32), jnp.cumsum(per_block, axis=0)], axis=0
    )
    total = occ[-1]
    C = jnp.concatenate([jnp.zeros(1, jnp.int32), jnp.cumsum(total)])
    return OccTable(blocks, occ, C, n, sigma, block)


def build_occ(bwt, sigma: int, block: int = DEFAULT_BLOCK) -> OccTable:
    """Build the occ structure on device from an int32 BWT array."""
    bwt = jnp.asarray(bwt, dtype=jnp.int32)
    return _build_occ_jax(bwt, int(sigma), int(block))


def _select_col(rows: jnp.ndarray, idx: jnp.ndarray) -> jnp.ndarray:
    """rows[j, idx[j]] via compare-mask sum — avoids a dependent element
    gather; compare+reduce over a row-gathered block is elementwise
    work."""
    col = lax.broadcasted_iota(jnp.int32, rows.shape, 1)
    return jnp.sum(jnp.where(col == idx[:, None], rows,
                             jnp.zeros_like(rows)), axis=1)


def rank_batch(occt, c: jnp.ndarray, i: jnp.ndarray) -> jnp.ndarray:
    """Batched rank: number of occurrences of c[j] in bwt[0 : i[j]).

    c, i: int32 [B]. Returns int32 [B]. Positions i in [0, n].
    Dispatches to the bit-plane-packed implementation when given a
    PackedOccTable. Uses only row gathers + mask-selects (no element
    gathers — see _select_col).
    """
    from .rank_packed import PackedOccTable, rank_batch_packed
    if isinstance(occt, PackedOccTable):
        return rank_batch_packed(occt, c, i)
    block = occt.block
    b = i // block
    bsafe = jnp.minimum(b, occt.bwt_blocks.shape[0] - 1)
    occ_rows = jnp.take(occt.occ, b, axis=0)        # [B, sigma] row gather
    base = _select_col(occ_rows, c)
    rows = jnp.take(occt.bwt_blocks, bsafe, axis=0)  # [B, block] row gather
    off = i - b * block
    col = lax.broadcasted_iota(jnp.int32, rows.shape, 1)
    inblk = jnp.sum(
        jnp.logical_and(rows == c[:, None], col < off[:, None]).astype(jnp.int32),
        axis=1,
    )
    return base + inblk


def rank_all_symbols_batch(occt: OccTable, i: jnp.ndarray) -> jnp.ndarray:
    """Batched rank for all symbols at once: out[j, c] = rank(c, i[j])."""
    block = occt.block
    b = i // block
    base = occt.occ[b]  # [B, sigma]
    rows = occt.bwt_blocks[jnp.minimum(b, occt.bwt_blocks.shape[0] - 1)]
    off = i - b * block
    col = lax.broadcasted_iota(jnp.int32, rows.shape, 1)
    sym_ids = lax.broadcasted_iota(jnp.int32, (1, 1, occt.sigma), 2)
    inblk = jnp.sum(
        jnp.logical_and(
            rows[:, :, None] == sym_ids, (col < off[:, None])[:, :, None]
        ).astype(jnp.int32),
        axis=1,
    )
    return base + inblk


def access_batch(occt, i: jnp.ndarray) -> jnp.ndarray:
    """Batched bwt[i] access (row gather + mask-select)."""
    from .rank_packed import PackedOccTable, access_batch_packed
    if isinstance(occt, PackedOccTable):
        return access_batch_packed(occt, i)
    block = occt.block
    b = i // block
    rows = jnp.take(occt.bwt_blocks,
                    jnp.minimum(b, occt.bwt_blocks.shape[0] - 1), axis=0)
    off = i - b * block
    return _select_col(rows, off)


def occ_total_counts(occt: OccTable) -> jnp.ndarray:
    return occt.occ[-1]

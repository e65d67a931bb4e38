"""Bit-plane fused rank rows — popcount rank for sigma <= 8.

The round-2 FusedOcc (ops/focc.py) answers a rank query with one [B, 384]
int8 row gather followed by ~15 compare-mask passes over the 256 symbol
columns.  This layout is the device translation of the reference's
per-symbol-bitvector rank (``lf::MultiRankCacheLF``,
/root/reference/src/bwttestdecodespeed.cpp:72): symbols live as bit
planes, and counting is XOR-AND word matching + hardware popcount.

    row[b] (128 bytes, int8[128], viewed as uint32[32]):
      words  0..7   bit-plane 0 of the block's 256 symbols (LSB-first)
      words  8..15  bit-plane 1
      words 16..23  bit-plane 2
      words 24..24+sigma-1   occ checkpoints (symbol counts before block)
      remaining words        zero pad

A rank(c, i) gathers ONE 128-byte row (3x less than FusedOcc), builds 8
match words ``(p0^e0)&(p1^e1)&(p2^e2)`` (e_j = ~0 iff bit j of c is 0),
masks positions >= i%256 and popcounts — ~90 int32 ops over [B, 8]
instead of ~1000 over [B, 384].  Memory: 0.5 B/symbol at any sigma <= 8
(vs 1.5 B/symbol), so a 3.2 G-symbol right region's rank rows take
1.6 GB HBM.  Counts are uint32 end-to-end: no 2^31 ceiling.

Rows are STORED int8 [nb_pad, 128] (the int8 tile is (32, 128), so the
minor dim is exactly one lane row and nothing is pad-tiled; an int32
[nb, 32] store would be tile-padded 4x) and bitcast to uint32 [B, 32]
after the gather.  Build and query use the same bitcast direction, so
byte order cancels.
"""

from __future__ import annotations

from functools import partial
from typing import Tuple

import jax
import jax.numpy as jnp
from jax import lax, tree_util

BLOCK = 256
WPR = 32          # uint32 words per row (= 128 bytes)
NPLANES = 3


class FusedOccBP:
    """Bit-plane rank rows + C array; pytree with static (n, sigma).
    ``block`` is fixed at 256. API-compatible with ops/focc.FusedOcc for
    every consumer that goes through the focc query functions."""

    block = BLOCK

    def __init__(self, rows, C, n, sigma):
        self.rows = rows      # int8 [nb_pad, 128]
        self.C = C            # uint32 [sigma+1]
        self.n = n
        self.sigma = sigma

    def tree_flatten(self):
        return (self.rows, self.C), (self.n, self.sigma)

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children, *aux)


tree_util.register_pytree_node(
    FusedOccBP, FusedOccBP.tree_flatten, FusedOccBP.tree_unflatten
)


@partial(jax.jit, static_argnums=(1, 2))
def _build_bp_jax(bwt: jnp.ndarray, sigma: int, nb_pad: int) -> FusedOccBP:
    n = bwt.shape[0]
    nb = (n + BLOCK - 1) // BLOCK
    pad = nb * BLOCK - n
    b32 = bwt.astype(jnp.int32)
    if pad:
        # pad with -1 so the occ checkpoints don't count pad positions;
        # the planes store the low bits (pattern 7) but queries never
        # count them either (the prefix mask keeps positions < i % 256
        # only, and i <= n keeps every pad position out of range)
        b32 = jnp.concatenate([b32, jnp.full((pad,), -1, jnp.int32)])
    blocks = b32.reshape(nb, BLOCK)
    sym_ids = lax.broadcasted_iota(jnp.int32, (1, 1, sigma), 2)
    per_block = jnp.sum(
        (blocks[:, :, None] == sym_ids).astype(jnp.uint32), axis=1)
    cum = jnp.cumsum(per_block, axis=0, dtype=jnp.uint32)
    occ = jnp.concatenate(
        [jnp.zeros((1, sigma), jnp.uint32), cum], axis=0)   # [nb+1, sigma]
    total = cum[-1]
    C = jnp.concatenate(
        [jnp.zeros(1, jnp.uint32), jnp.cumsum(total, dtype=jnp.uint32)])

    # planes: [nb, NPLANES, 8] uint32, LSB-first within each word
    shift = lax.broadcasted_iota(jnp.uint32, (1, 1, 1, 32), 3)
    bits = blocks.reshape(nb, 1, 8, 32) >> lax.broadcasted_iota(
        jnp.int32, (1, NPLANES, 1, 1), 1)
    words = jnp.sum(((bits & 1).astype(jnp.uint32) << shift),
                    axis=3)                                  # [nb, NPLANES, 8]

    rows_u32 = jnp.zeros((nb_pad, WPR), jnp.uint32)
    rows_u32 = rows_u32.at[:nb, : NPLANES * 8].set(
        words.reshape(nb, NPLANES * 8))
    rows_u32 = rows_u32.at[: nb + 1, NPLANES * 8 : NPLANES * 8 + sigma].set(
        occ)
    rows = lax.bitcast_convert_type(rows_u32, jnp.int8).reshape(nb_pad, 4 * WPR)
    return FusedOccBP(rows, C, n, sigma)


def build_focc_bp(bwt, sigma: int, pad_shape: bool = True) -> FusedOccBP:
    from .focc import _pad_rows

    bwt = jnp.asarray(bwt)
    n = int(bwt.shape[0])
    nb = max(1, (n + BLOCK - 1) // BLOCK)
    nb_pad = _pad_rows(nb + 1) if pad_shape else nb + 1
    return _build_bp_jax(bwt, int(sigma), int(nb_pad))


# ------------------------------------------------------------------ queries

def _gather_words(focc: FusedOccBP, i: jnp.ndarray
                  ) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """One 128-byte row gather per lane; returns (words [B, 32] uint32,
    off uint32 in [0, 256))."""
    b = (i >> jnp.uint32(8)).astype(jnp.int32)
    b = jnp.minimum(b, focc.rows.shape[0] - 1)
    rows = jnp.take(focc.rows, b, axis=0)                # [B, 128] int8
    words = lax.bitcast_convert_type(
        rows.reshape(rows.shape[0], WPR, 4), jnp.uint32)  # [B, 32]
    return words, i & jnp.uint32(255)


def _match_words(words: jnp.ndarray, c: jnp.ndarray) -> jnp.ndarray:
    """[B, 8] words whose set bits mark positions holding symbol c[j]."""
    planes = words[:, : NPLANES * 8].reshape(-1, NPLANES, 8)
    cbits = (c.astype(jnp.uint32)[:, None] >>
             lax.broadcasted_iota(jnp.uint32, (1, NPLANES), 1)) & 1
    e = (cbits - jnp.uint32(1))[:, :, None]      # ~0 where bit == 0
    m = planes ^ e
    return m[:, 0, :] & m[:, 1, :] & m[:, 2, :]


def _prefix_mask(off: jnp.ndarray) -> jnp.ndarray:
    """[B, 8] words masking positions < off (off in [0, 256])."""
    w32 = lax.broadcasted_iota(jnp.uint32, (off.shape[0], 8), 1) * 32
    keep = jnp.clip(off[:, None].astype(jnp.int32) - w32.astype(jnp.int32),
                    0, 32)
    full = jnp.uint32(0xFFFFFFFF)
    # (full >> (32-keep)) is UB at keep == 0; select both ends explicitly
    part = full >> (jnp.uint32(32) - keep.astype(jnp.uint32) % 32)
    return jnp.where(keep == 0, jnp.uint32(0),
                     jnp.where(keep == 32, full, part))


def _inblock_bp(words: jnp.ndarray, c: jnp.ndarray,
                off: jnp.ndarray) -> jnp.ndarray:
    m = _match_words(words, c) & _prefix_mask(off)
    return jnp.sum(lax.population_count(m), axis=1)


def _occ_base_bp(focc: FusedOccBP, words: jnp.ndarray,
                 c: jnp.ndarray) -> jnp.ndarray:
    occw = words[:, NPLANES * 8 : NPLANES * 8 + focc.sigma]
    col = lax.broadcasted_iota(jnp.int32, occw.shape, 1)
    return jnp.sum(jnp.where(col == c[:, None], occw, jnp.uint32(0)), axis=1)


def _symbol_at_bp(words: jnp.ndarray, off: jnp.ndarray) -> jnp.ndarray:
    planes = words[:, : NPLANES * 8].reshape(-1, NPLANES, 8)
    w = (off >> jnp.uint32(5)).astype(jnp.int32)
    col = lax.broadcasted_iota(jnp.int32, (off.shape[0], 1, 8), 2)
    pw = jnp.sum(jnp.where(col == w[:, None, None], planes, jnp.uint32(0)),
                 axis=2)                                   # [B, NPLANES]
    bits = (pw >> (off & jnp.uint32(31))[:, None]) & 1
    sh = lax.broadcasted_iota(jnp.uint32, (1, NPLANES), 1)
    return jnp.sum(bits << sh, axis=1).astype(jnp.int32)


def _select_c_bp(focc: FusedOccBP, c: jnp.ndarray) -> jnp.ndarray:
    ctab = jnp.broadcast_to(focc.C[None, : focc.sigma],
                            (c.shape[0], focc.sigma))
    col = lax.broadcasted_iota(jnp.int32, ctab.shape, 1)
    return jnp.sum(jnp.where(col == c[:, None], ctab, jnp.uint32(0)), axis=1)


def rank_batch_bp(focc: FusedOccBP, c: jnp.ndarray, i: jnp.ndarray
                  ) -> jnp.ndarray:
    words, off = _gather_words(focc, i.astype(jnp.uint32))
    return _occ_base_bp(focc, words, c) + _inblock_bp(words, c, off)


def access_batch_bp(focc: FusedOccBP, i: jnp.ndarray) -> jnp.ndarray:
    words, off = _gather_words(focc, i.astype(jnp.uint32))
    return _symbol_at_bp(words, off)


def lf_step_batch_bp(focc: FusedOccBP, r: jnp.ndarray
                     ) -> Tuple[jnp.ndarray, jnp.ndarray]:
    words, off = _gather_words(focc, r.astype(jnp.uint32))
    sym = _symbol_at_bp(words, off)
    r2 = (_select_c_bp(focc, sym) + _occ_base_bp(focc, words, sym)
          + _inblock_bp(words, sym, off))
    return sym, r2


def lf_step_words_fused(focc: FusedOccBP, words: jnp.ndarray,
                        off: jnp.ndarray
                        ) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Extended LF from pre-gathered row words in exactly TWO reduction
    stages (the data-dependence minimum: symbol bits, then one combined
    sum) instead of the four of the naive composition — the per-iteration
    kernel count is the walk-loop floor (batched gathers are
    per-element-bound; everything else is fixed per-kernel overhead).

    Stage 1: sym bits b_j = plane_j[off>>5] >> (off&31) & 1, all planes
    via one [B, NPLANES, 8] masked reduce.  Stage 2:
    r2 = C[sym] + occ[sym] + popcount(match & prefix)
    with the C and occ selects sharing one mask (same [B, sigma] columns)
    and the 8 popcount words adding into the same sum."""
    sigma = focc.sigma
    B = off.shape[0]
    planes = words[:, : NPLANES * 8].reshape(-1, NPLANES, 8)
    w = (off >> jnp.uint32(5)).astype(jnp.int32)
    colw = lax.broadcasted_iota(jnp.int32, (B, 1, 8), 2)
    pw = jnp.sum(jnp.where(colw == w[:, None, None], planes,
                           jnp.uint32(0)), axis=2)        # [B, NPLANES]
    bits = (pw >> (off & jnp.uint32(31))[:, None]) & 1    # [B, NPLANES]
    sh = lax.broadcasted_iota(jnp.uint32, (1, NPLANES), 1)
    sym = jnp.sum(bits << sh, axis=1).astype(jnp.int32)   # reduce #1

    e = (bits - jnp.uint32(1))[:, :, None]                # ~0 iff bit 0
    m = planes ^ e
    m = (m[:, 0, :] & m[:, 1, :] & m[:, 2, :]) & _prefix_mask(off)
    pc = lax.population_count(m)                          # [B, 8]
    occw = words[:, NPLANES * 8 : NPLANES * 8 + sigma]
    ctab = jnp.broadcast_to(focc.C[None, :sigma], (B, sigma))
    cols = lax.broadcasted_iota(jnp.int32, (B, sigma), 1)
    sel = jnp.where(cols == sym[:, None], occw + ctab, jnp.uint32(0))
    r2 = jnp.sum(jnp.concatenate([pc, sel], axis=1), axis=1)  # reduce #2
    return sym, r2


def lf_step_batch_bp2(focc: FusedOccBP, r: jnp.ndarray
                      ) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """lf_step_batch_bp with the two-stage fused arithmetic."""
    words, off = _gather_words(focc, r.astype(jnp.uint32))
    return lf_step_words_fused(focc, words, off)


def backward_step_bp(focc: FusedOccBP, c: jnp.ndarray, lo: jnp.ndarray,
                     hi: jnp.ndarray) -> Tuple[jnp.ndarray, jnp.ndarray]:
    csel = _select_c_bp(focc, c)
    return (csel + rank_batch_bp(focc, c, lo),
            csel + rank_batch_bp(focc, c, hi))


def rank_all_batch_bp(focc: FusedOccBP, i: jnp.ndarray) -> jnp.ndarray:
    """[B, sigma] uint32: occ_c(i[j]) for EVERY symbol from the same one
    row gather — the checkpoint words carry all sigma bases and the
    in-block counts come from sigma match-word popcounts over the same
    plane words. This powers the bidirectional index's smaller-symbol
    prefix sums (one gather instead of sigma)."""
    sigma = focc.sigma
    words, off = _gather_words(focc, i.astype(jnp.uint32))
    occw = words[:, NPLANES * 8 : NPLANES * 8 + sigma]    # [B, sigma]
    planes = words[:, : NPLANES * 8].reshape(-1, 1, NPLANES, 8)
    cbits = (lax.broadcasted_iota(jnp.uint32, (1, sigma, NPLANES, 1), 1)
             >> lax.broadcasted_iota(jnp.uint32, (1, sigma, NPLANES, 1), 2)
             ) & 1
    e = cbits - jnp.uint32(1)                  # ~0 where symbol bit == 0
    m = planes ^ e                             # [B, sigma, NPLANES, 8]
    m = m[:, :, 0, :] & m[:, :, 1, :] & m[:, :, 2, :]
    m = m & _prefix_mask(off)[:, None, :]
    inblk = jnp.sum(lax.population_count(m), axis=2)      # [B, sigma]
    return occw + inblk

"""Two-word (hi, lo) rank queries for texts past 2^32 symbols.

The fused rank rows (ops/focc.py byte rows, ops/focc_bp.py bit planes)
store occ checkpoints as uint32 — exact for n < 2^32, wrapped past it.
The reference is 64-bit end-to-end (/root/reference/src/lcpbit.cpp:552:
text length bounded only by rlimit/disk), so the whole-text walk kernels
(checkbwt, bwtcomputessa) need wider rank words at 2^32+.

Instead of widening the rows (a 5th count byte would break the one-row
128-byte gather layout), the hi word is DERIVED: occ_c is nondecreasing
in the block row, and its uint32 lo word wraps at most a handful of
times (once per 2^32 occurrences), so

    hi(c, row) = #{ k : thr[c, k] <= row }

for a tiny per-symbol table ``thr`` of the block rows where the stored
lo word wrapped.  The table stays on chip after broadcast —
the hi word costs ~sigma*K compares and NO extra memory traffic, and the
row gather stays one 128-byte (or 384-byte) row per query.

Positions/ranks travel as (hi, lo) uint32 pairs; the row index is
hi * 2^24 | lo >> 8 (int32-safe to 2^39 symbols).  Carry discipline: all
addends besides the checkpoint are < 2^32, so each addition carries iff
the uint32 sum is smaller than either operand.

Verified against a synthetic occ structure whose checkpoints straddle
2^32 (tests/test_wideocc.py) — a real 4 G-symbol build cannot run under
CPU tests.
"""

from __future__ import annotations

from typing import Tuple

import jax.numpy as jnp
import numpy as np
from jax import lax, tree_util

from .focc import FusedOcc, _inblock_count, _occ_base, _symbol_at
from .focc_bp import (NPLANES, FusedOccBP, _inblock_bp, _occ_base_bp,
                      _symbol_at_bp)

THR_K = 8          # max tracked wraps per symbol: exact to n = 2^35


class WideOcc:
    """Wrapper pytree: fused rows (lo words) + wrap-row thresholds + a
    64-bit C array split in words. API mirrors the focc query helpers
    with (hi, lo) pairs."""

    def __init__(self, focc, thr, C_hi, n):
        self.focc = focc          # FusedOcc or FusedOccBP (lo words)
        self.thr = thr            # uint32 [sigma, THR_K]; 0xFFFFFFFF pad
        self.C_hi = C_hi          # uint32 [sigma + 1]
        self.n = n                # true length (python int)

    @property
    def sigma(self):
        return self.focc.sigma

    @property
    def block(self):
        return self.focc.block

    def tree_flatten(self):
        return (self.focc, self.thr, self.C_hi), (self.n,)

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children, *aux)


tree_util.register_pytree_node(
    WideOcc, WideOcc.tree_flatten, WideOcc.tree_unflatten
)


def row_of(hi: jnp.ndarray, lo: jnp.ndarray) -> jnp.ndarray:
    """Block row of position (hi, lo) as int32 (valid to 2^39 symbols)."""
    return ((hi << jnp.uint32(24)) | (lo >> jnp.uint32(8))).astype(jnp.int32)


def _hi_counts(w: WideOcc, row: jnp.ndarray, c: jnp.ndarray) -> jnp.ndarray:
    """#wrap thresholds <= row for symbol c[j] (uint32 [B])."""
    sigma = w.sigma
    rows_u = row.astype(jnp.uint32)
    hit = (w.thr[None, :, :] <= rows_u[:, None, None])     # [B, sigma, K]
    cnts = jnp.sum(hit.astype(jnp.uint32), axis=2)          # [B, sigma]
    col = lax.broadcasted_iota(jnp.int32, cnts.shape, 1)
    return jnp.sum(jnp.where(col == c[:, None], cnts, jnp.uint32(0)), axis=1)


def _gather_at_row(w: WideOcc, row: jnp.ndarray, lo: jnp.ndarray):
    """Row gather addressed by block row (not by flat position)."""
    focc = w.focc
    off = lo & jnp.uint32(255)
    if isinstance(focc, FusedOcc):
        b = jnp.minimum(row, focc.rows.shape[0] - 1)
        rows = jnp.take(focc.rows, b, axis=0)
        return rows, off
    b = jnp.minimum(row, focc.rows.shape[0] - 1)
    rows8 = jnp.take(focc.rows, b, axis=0)
    words = lax.bitcast_convert_type(
        rows8.reshape(rows8.shape[0], 32, 4), jnp.uint32)
    return words, off


def _rank_parts(w: WideOcc, rowsdat, off, row, c):
    """(hi, lo) of occ(c, position) given the gathered row data."""
    focc = w.focc
    if isinstance(focc, FusedOcc):
        base = _occ_base(focc, rowsdat, c)
        inblk = _inblock_count(focc, rowsdat, c, off)
    else:
        base = _occ_base_bp(focc, rowsdat, c)
        inblk = _inblock_bp(rowsdat, c, off)
    lo = base + inblk
    hi = _hi_counts(w, row, c) + (lo < base).astype(jnp.uint32)
    return hi, lo


def rank_batch_w(w: WideOcc, c: jnp.ndarray, i_hi: jnp.ndarray,
                 i_lo: jnp.ndarray) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Batched wide rank: occurrences of c[j] in bwt[0 : (i_hi, i_lo))."""
    row = row_of(i_hi.astype(jnp.uint32), i_lo.astype(jnp.uint32))
    rowsdat, off = _gather_at_row(w, row, i_lo.astype(jnp.uint32))
    return _rank_parts(w, rowsdat, off, row, c)


def access_batch_w(w: WideOcc, i_hi: jnp.ndarray,
                   i_lo: jnp.ndarray) -> jnp.ndarray:
    row = row_of(i_hi.astype(jnp.uint32), i_lo.astype(jnp.uint32))
    rowsdat, off = _gather_at_row(w, row, i_lo.astype(jnp.uint32))
    if isinstance(w.focc, FusedOcc):
        return _symbol_at(w.focc, rowsdat, off)
    return _symbol_at_bp(rowsdat, off)


def _select_c_words(w: WideOcc, c: jnp.ndarray):
    sigma = w.sigma
    Clo = jnp.broadcast_to(w.focc.C[None, :sigma], (c.shape[0], sigma))
    Chi = jnp.broadcast_to(w.C_hi[None, :sigma], (c.shape[0], sigma))
    col = lax.broadcasted_iota(jnp.int32, Clo.shape, 1)
    sel = col == c[:, None]
    return (jnp.sum(jnp.where(sel, Chi, jnp.uint32(0)), axis=1),
            jnp.sum(jnp.where(sel, Clo, jnp.uint32(0)), axis=1))


def lf_step_batch_w(w: WideOcc, r_hi: jnp.ndarray, r_lo: jnp.ndarray
                    ) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Wide extended LF: (sym, r'_hi, r'_lo) from ONE row gather."""
    r_hi = r_hi.astype(jnp.uint32)
    r_lo = r_lo.astype(jnp.uint32)
    row = row_of(r_hi, r_lo)
    rowsdat, off = _gather_at_row(w, row, r_lo)
    if isinstance(w.focc, FusedOcc):
        sym = _symbol_at(w.focc, rowsdat, off)
    else:
        sym = _symbol_at_bp(rowsdat, off)
    occ_hi, occ_lo = _rank_parts(w, rowsdat, off, row, sym)
    c_hi, c_lo = _select_c_words(w, sym)
    lo = c_lo + occ_lo
    hi = c_hi + occ_hi + (lo < c_lo).astype(jnp.uint32)
    return sym, hi, lo


# ------------------------------------------------------------------ build

def occ_words_from_row(focc, row_bytes: np.ndarray) -> np.ndarray:
    """Host-side parse of one fused row's occ checkpoint lo words."""
    sigma = focc.sigma
    if isinstance(focc, FusedOcc):
        block = focc.block
        b = row_bytes.astype(np.uint8)[block : block + 4 * sigma]
        return b.reshape(sigma, 4).view("<u4").reshape(sigma).copy()
    words = row_bytes.astype(np.uint8).reshape(32, 4).view("<u4").reshape(32)
    return words[NPLANES * 8 : NPLANES * 8 + sigma].copy()


def find_wrap_rows(focc, chunk_bases: np.ndarray, chunk_rows: int,
                   nb: int) -> np.ndarray:
    """Block rows where each symbol's stored occ lo word wrapped.

    ``chunk_bases[k]`` is the lo word after chunk k (uint32 [nchunks,
    sigma]); a decrease between consecutive bases brackets exactly one
    wrap (chunk increments < 2^32), located by binary search over the
    chunk's checkpoint rows with one tiny device row fetch per probe.
    Returns uint32 [sigma, THR_K] padded with 0xFFFFFFFF."""
    sigma = focc.sigma
    bases = np.concatenate(
        [np.zeros((1, sigma), np.uint32), chunk_bases], axis=0)
    thr = np.full((sigma, THR_K), 0xFFFFFFFF, np.uint32)
    counts = np.zeros(sigma, np.int64)
    rows_dev = focc.rows

    def occ_at(row: int) -> np.ndarray:
        return occ_words_from_row(focc, np.asarray(rows_dev[row]))

    for c in range(sigma):
        for k in range(len(chunk_bases)):
            if bases[k + 1, c] >= bases[k, c]:
                continue
            # wrap inside chunk k: first checkpoint row r in
            # (k*chunk_rows, (k+1)*chunk_rows] with occ_lo < base
            lo_r, hi_r = k * chunk_rows, min((k + 1) * chunk_rows, nb)
            base = int(bases[k, c])
            while lo_r + 1 < hi_r:
                mid = (lo_r + hi_r) // 2
                if int(occ_at(mid)[c]) < base:
                    hi_r = mid
                else:
                    lo_r = mid
            assert counts[c] < THR_K, "more than THR_K wraps (n >= 2^35?)"
            thr[c, counts[c]] = hi_r
            counts[c] += 1
    return thr


def widen_focc(focc, chunk_bases: np.ndarray, chunk_rows: int,
               n: int) -> WideOcc:
    """Assemble a WideOcc from a freshly chunk-built focc plus the
    per-chunk running bases recorded during the build."""
    sigma = focc.sigma
    nb = max(1, (n + focc.block - 1) // focc.block)
    thr = find_wrap_rows(focc, chunk_bases, chunk_rows, nb)
    wraps = np.sum(thr != 0xFFFFFFFF, axis=1).astype(np.uint64)
    final_lo = (chunk_bases[-1].astype(np.uint64)
                if len(chunk_bases) else np.zeros(sigma, np.uint64))
    totals = (wraps << np.uint64(32)) + final_lo
    C_full = np.zeros(sigma + 1, np.uint64)
    C_full[1:] = np.cumsum(totals)
    C_lo = (C_full & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    C_hi = (C_full >> np.uint64(32)).astype(np.uint32)
    # the focc C array built from wrapped uint32 math already equals C_lo
    focc.C = jnp.asarray(C_lo)
    return WideOcc(focc, jnp.asarray(thr), jnp.asarray(C_hi), n)

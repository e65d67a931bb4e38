"""Chunked, 2-D-safe construction of the fused rank structures from a
host-resident BWT.

The original builders (ops/focc.py ``_build_focc_jax``, ops/focc_bp.py
``_build_bp_jax``) take the whole BWT as ONE flat device array.  That
breaks at scale twice over:

1. int32 indexing reaches at most 2^31-1 elements per dimension (a flat
   int8 [2^31 + 1024] array read with int32 indices silently misreads —
   see ops/gapdev.build_text_rows), so any text past ~2.1 G symbols
   would corrupt the structure silently.  The reference is 64-bit end-to-end
   (/root/reference/src/lcpbit.cpp:552-557 bounds only by rlimit/disk);
   checkbwt/bwtcomputessa over a 2.2-3.2 Gbp build land exactly here.
2. The build materializes ~4 bytes/symbol of int32 transients — 13 GB at
   a 3.2 G-symbol right region.

This module streams the BWT through a fixed-shape chunk program instead:
each chunk uploads bit-packed bytes, unpacks on device, computes its
plane words / symbol rows plus occ checkpoints offset by a
device-resident running base, and writes them into the preallocated row
buffer with ``lax.dynamic_update_slice`` (donated, in place).  Peak
transient is O(chunk) regardless of n, every shape is bucketed, and no
flat array ever exceeds chunk size.  Row layouts are byte-identical to
the monolithic builders (pinned by tests/test_focc_build.py).

Validity masking uses block-row arithmetic (row ids < 2^25 at 2^33
symbols), never flat positions, so the builder itself is safe past
2^31/2^32 symbols; occ checkpoints stay uint32 (exact for n < 2^32 —
wider texts get the threshold-based hi word, ops/wideocc.py).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from .focc import FusedOcc, _pad_rows, _row_width
from .focc_bp import NPLANES, WPR, FusedOccBP

BLOCK = 256
_CHUNK_ROWS_MAX = 1 << 17          # 2^17 blocks = 32 M symbols per chunk


def _chunk_rows_for(nb_pad: int, override: int = 0) -> int:
    """Largest power-of-two divisor of nb_pad, capped at _CHUNK_ROWS_MAX.
    nb_pad comes from _pad_rows (quarter-octave buckets = (4+k) * 2^j),
    so the divisor is >= nb_pad/8 for small buffers and 2^17 at scale —
    a handful of compiled chunk shapes ever."""
    if override:
        assert nb_pad % override == 0
        return override
    return min(nb_pad, 1 << min(_CHUNK_ROWS_MAX.bit_length() - 1,
                                (nb_pad & -nb_pad).bit_length() - 1))


def _valid_counts(start, g: int, nfull, nrem):
    """[g] int32 count of in-range symbols per block row: 256 for rows
    before the boundary block, n%256 at it, 0 past it."""
    rowid = start + lax.broadcasted_iota(jnp.int32, (g,), 0)
    return jnp.where(rowid < nfull, 256,
                     jnp.where(rowid == nfull, nrem, 0))


def _unpack_chunk(packed: jnp.ndarray, g: int, bits: int) -> jnp.ndarray:
    """Packed chunk bytes -> [g, 256] int32 symbols (LSB-first nibbles
    for bits=4, raw bytes for bits=8)."""
    if bits == 8:
        return (packed.astype(jnp.int32) & 0xFF).reshape(g, BLOCK)
    total = packed.shape[0] * 2
    arr = jnp.repeat(packed, 2, total_repeat_length=total)
    pos = lax.broadcasted_iota(jnp.int32, (total,), 0)
    syms = (arr.astype(jnp.int32) >> ((pos & 1) * 4)) & 0xF
    return syms.reshape(g, BLOCK)


def _per_block_counts(blocks: jnp.ndarray, valid: jnp.ndarray,
                      sigma: int) -> jnp.ndarray:
    col = lax.broadcasted_iota(jnp.int32, blocks.shape, 1)
    inrange = col < valid[:, None]
    sym_ids = lax.broadcasted_iota(jnp.int32, (1, 1, sigma), 2)
    hit = jnp.logical_and(blocks[:, :, None] == sym_ids,
                          inrange[:, :, None])
    return jnp.sum(hit.astype(jnp.uint32), axis=1)        # [g, sigma]


@partial(jax.jit, static_argnums=(0, 1, 2), donate_argnums=(5,))
def _bp_chunk(g: int, sigma: int, bits: int, packed, base, rows,
              start, nfull, nrem):
    """One bit-plane chunk: plane words + occ checkpoints for block rows
    [start, start+g), written in place. Returns (rows, base + counts)."""
    blocks = _unpack_chunk(packed, g, bits)
    valid = _valid_counts(start, g, nfull, nrem)
    per_block = _per_block_counts(blocks, valid, sigma)
    cum = jnp.cumsum(per_block, axis=0, dtype=jnp.uint32)
    occ = base[None, :] + (cum - per_block)                # exclusive
    new_base = base + cum[-1]

    shift = lax.broadcasted_iota(jnp.uint32, (1, 1, 1, 32), 3)
    bits3 = blocks.reshape(g, 1, 8, 32) >> lax.broadcasted_iota(
        jnp.int32, (1, NPLANES, 1, 1), 1)
    words = jnp.sum(((bits3 & 1).astype(jnp.uint32) << shift),
                    axis=3)                                # [g, NPLANES, 8]
    rows_u32 = jnp.zeros((g, WPR), jnp.uint32)
    rows_u32 = rows_u32.at[:, : NPLANES * 8].set(
        words.reshape(g, NPLANES * 8))
    rows_u32 = rows_u32.at[:, NPLANES * 8 : NPLANES * 8 + sigma].set(occ)
    chunk_rows = lax.bitcast_convert_type(
        rows_u32, jnp.int8).reshape(g, 4 * WPR)
    rows = lax.dynamic_update_slice(rows, chunk_rows, (start, 0))
    return rows, new_base


@partial(jax.jit, static_argnums=(0, 1, 2, 3), donate_argnums=(6,))
def _bytes_chunk(g: int, sigma: int, bits: int, roww: int, packed, base,
                 rows, start, nfull, nrem):
    """One byte-row chunk (FusedOcc layout: 256 symbol bytes + 4 LE count
    bytes per symbol)."""
    blocks = _unpack_chunk(packed, g, bits)
    valid = _valid_counts(start, g, nfull, nrem)
    per_block = _per_block_counts(blocks, valid, sigma)
    cum = jnp.cumsum(per_block, axis=0, dtype=jnp.uint32)
    occ = base[None, :] + (cum - per_block)
    new_base = base + cum[-1]

    shifts = jnp.array([0, 8, 16, 24], jnp.uint32)
    occ_bytes = ((occ[:, :, None] >> shifts[None, None, :]) & 0xFF).astype(
        jnp.int8).reshape(g, 4 * sigma)
    chunk_rows = jnp.zeros((g, roww), jnp.int8)
    chunk_rows = chunk_rows.at[:, :BLOCK].set(blocks.astype(jnp.int8))
    chunk_rows = chunk_rows.at[:, BLOCK : BLOCK + 4 * sigma].set(occ_bytes)
    rows = lax.dynamic_update_slice(rows, chunk_rows, (start, 0))
    return rows, new_base


def _pack_host(chunk: np.ndarray, bits: int) -> np.ndarray:
    if bits == 8:
        return chunk
    from .. import native
    packed = native.pack_bits_u8(chunk, 4)
    if packed is None:
        from ..io.compact import pack_bits
        packed = np.asarray(pack_bits(chunk.astype(np.int64), 4), np.uint8)
    return packed


def _rows_chunk_slice(region_rows, r0: int, g: int):
    """g consecutive packed rows from a device region-rows buffer,
    flattened to the chunk programs' 1-D packed layout; rows past the
    buffer (shape-bucketed pads may fall one row short of the occ
    builder's nb+1 coverage) read as zeros, which the nfull/nrem masks
    ignore anyway."""
    have = min(max(region_rows.shape[0] - r0, 0), g)
    sl = region_rows[r0 : r0 + have].reshape(-1)
    w = region_rows.shape[1]
    if have < g:
        sl = jnp.concatenate([sl, jnp.zeros((g - have) * w, jnp.int8)])
    return sl


def build_focc_from_rows(region_rows, n: int, sigma: int,
                         chunk_rows: int = 0, return_bases: bool = False):
    """Fused rank structure from DEVICE-resident packed region rows
    (ops/devzip.py layout) — no host pack, no host->device transfer.
    Row contents are byte-identical to build_focc_host on the same
    symbols (shared chunk programs).

    ``return_bases`` additionally returns (chunk_bases uint32
    [nchunks, sigma], chunk_rows) for ops/wideocc.widen_focc — the
    per-chunk bases stay on device and reach the host as ONE stacked
    fetch (a per-chunk fetch would cost a round trip each)."""
    import os

    if sigma > 256:
        raise ValueError("fused rank rows store symbols as bytes "
                         "(sigma <= 256)")
    bits = 4 if region_rows.shape[1] == BLOCK // 2 else 8
    nb = max(1, (n + BLOCK - 1) // BLOCK)
    nb_pad = _pad_rows(nb + 1)
    bitplane = sigma <= 8 and os.environ.get("BWTB3M_FOCC") != "legacy"
    assert not (bitplane and bits != 4)
    g = _chunk_rows_for(nb_pad, chunk_rows)
    nchunks = (nb + 1 + g - 1) // g
    roww = 4 * WPR if bitplane else _row_width(sigma, BLOCK)
    rows = jnp.zeros((nb_pad, roww), jnp.int8)
    base = jnp.zeros((sigma,), jnp.uint32)
    nfull = jnp.int32(n // BLOCK)
    nrem = jnp.int32(n % BLOCK)
    bases_dev = [] if return_bases else None
    for k in range(nchunks):
        packed = _rows_chunk_slice(region_rows, k * g, g)
        if bitplane:
            rows, base = _bp_chunk(g, sigma, bits, packed, base, rows,
                                   jnp.int32(k * g), nfull, nrem)
        else:
            rows, base = _bytes_chunk(g, sigma, bits, roww, packed, base,
                                      rows, jnp.int32(k * g), nfull, nrem)
        if bases_dev is not None:
            bases_dev.append(base)
    total = np.asarray(base).astype(np.uint64)
    C = np.zeros(sigma + 1, np.uint32)
    C[1:] = np.cumsum(total).astype(np.uint32)
    Cj = jnp.asarray(C)
    focc = (FusedOccBP(rows, Cj, n, sigma) if bitplane
            else FusedOcc(rows, Cj, n, sigma, BLOCK))
    if return_bases:
        cb = (np.asarray(jnp.stack(bases_dev)).astype(np.uint32)
              if bases_dev else np.zeros((0, sigma), np.uint32))
        return focc, cb, g
    return focc


def build_focc_host(bwt: np.ndarray, sigma: int, pad_shape: bool = True,
                    chunk_rows: int = 0, return_bases: bool = False):
    """Build the fused rank structure for a HOST uint8 BWT of any length
    (the 2^31 flat-buffer ceiling does not apply).  Dispatches to the
    bit-plane layout for sigma <= 8 (unless BWTB3M_FOCC=legacy) and the
    byte-row layout otherwise; row contents are identical to
    ``build_focc`` on the same input.  ``chunk_rows`` is a test hook
    forcing a chunk size (must divide the padded row count).

    ``return_bases`` additionally returns (chunk_bases uint32
    [nchunks, sigma], chunk_rows) — the per-chunk running occ lo words
    that ops/wideocc.widen_focc needs to derive the hi-word wrap table
    for texts past 2^32 symbols."""
    import os

    if sigma > 256:
        raise ValueError("fused rank rows store symbols as bytes "
                         "(sigma <= 256)")
    bwt = np.ascontiguousarray(bwt, dtype=np.uint8)
    n = len(bwt)
    nb = max(1, (n + BLOCK - 1) // BLOCK)
    nb_pad = _pad_rows(nb + 1) if pad_shape else nb + 1
    bitplane = sigma <= 8 and os.environ.get("BWTB3M_FOCC") != "legacy"
    if not pad_shape:
        # unpadded shapes have no divisor guarantee: single chunk
        chunk_rows = chunk_rows or nb_pad
        if nb_pad % chunk_rows:
            chunk_rows = nb_pad
    g = _chunk_rows_for(nb_pad, chunk_rows)
    nchunks = (nb + 1 + g - 1) // g          # cover rows [0, nb] at least
    bits = 4 if sigma <= 15 or bitplane else 8

    roww = 4 * WPR if bitplane else _row_width(sigma, BLOCK)
    rows = jnp.zeros((nb_pad, roww), jnp.int8)
    base = jnp.zeros((sigma,), jnp.uint32)
    nfull = jnp.int32(n // BLOCK)
    nrem = jnp.int32(n % BLOCK)
    gsym = g * BLOCK
    bases = [] if return_bases else None
    for k in range(nchunks):
        a = k * gsym
        chunk = bwt[a : a + gsym]
        if len(chunk) < gsym:
            chunk = np.concatenate(
                [chunk, np.zeros(gsym - len(chunk), np.uint8)])
        packed = _pack_host(chunk, bits)
        packed = jnp.asarray(packed)
        if bitplane:
            rows, base = _bp_chunk(g, sigma, bits, packed, base, rows,
                                   jnp.int32(k * g), nfull, nrem)
        else:
            rows, base = _bytes_chunk(g, sigma, bits, roww, packed, base,
                                      rows, jnp.int32(k * g), nfull, nrem)
        if bases is not None:
            bases.append(np.asarray(base, dtype=np.uint32))
    total = np.asarray(base).astype(np.uint64)
    C = np.zeros(sigma + 1, np.uint32)
    C[1:] = np.cumsum(total).astype(np.uint32)
    Cj = jnp.asarray(C)
    focc = (FusedOccBP(rows, Cj, n, sigma) if bitplane
            else FusedOcc(rows, Cj, n, sigma, BLOCK))
    if return_bases:
        cb = (np.stack(bases) if bases
              else np.zeros((0, sigma), np.uint32))
        return focc, cb, g
    return focc

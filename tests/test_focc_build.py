"""Chunked focc builder (ops/focc_build.py) vs the monolithic device
builders — occ checkpoints byte-identical, every query equal.

The chunked path is what checkbwt/bwtcomputessa/the merge engine use at
scale (flat device BWT arrays break past 2^31 elements); these tests pin
it to the small-input ground truth on multi-chunk configurations.
"""

import numpy as np
import pytest

jnp = pytest.importorskip("jax.numpy")

from bwtb3m.ops.focc import (
    access_batch_f, build_focc, lf_step_batch_f, rank_batch_f)
from bwtb3m.ops.focc_build import build_focc_host


def _assert_equivalent(f_ref, f_new, n, sigma, rng):
    assert f_new.n == f_ref.n == n
    assert np.array_equal(np.asarray(f_new.C), np.asarray(f_ref.C))
    qs = rng.integers(0, n + 1, 512).astype(np.uint32)
    cs = rng.integers(0, sigma, 512).astype(np.int32)
    assert np.array_equal(
        np.asarray(rank_batch_f(f_ref, jnp.asarray(cs), jnp.asarray(qs))),
        np.asarray(rank_batch_f(f_new, jnp.asarray(cs), jnp.asarray(qs))))
    ps = rng.integers(0, n, 512).astype(np.uint32)
    assert np.array_equal(
        np.asarray(access_batch_f(f_ref, jnp.asarray(ps))),
        np.asarray(access_batch_f(f_new, jnp.asarray(ps))))
    s_ref, r_ref = lf_step_batch_f(f_ref, jnp.asarray(ps))
    s_new, r_new = lf_step_batch_f(f_new, jnp.asarray(ps))
    assert np.array_equal(np.asarray(s_ref), np.asarray(s_new))
    assert np.array_equal(np.asarray(r_ref), np.asarray(r_new))


@pytest.mark.parametrize("sigma,n,chunk", [
    (5, 300_000, 128),          # bit-plane, many chunks
    (5, 262_144, 256),          # exact block multiple boundary
    (5, 70_001, 0),             # auto chunking, ragged tail block
    (2, 4_000, 64),             # tiny alphabet
    (8, 130_000, 512),          # bit-plane at the sigma=8 edge
    (12, 120_000, 128),         # byte-row, nibble transfer
    (16, 50_000, 64),           # byte-row edge of nibble packing
    (200, 90_000, 256),         # byte-row, raw byte transfer
    (256, 66_000, 128),         # full byte alphabet (no spare pad symbol)
])
def test_chunked_matches_monolithic(sigma, n, chunk):
    rng = np.random.default_rng(sigma * 1000 + n)
    bwt = rng.integers(0, sigma, n).astype(np.uint8)
    f_ref = build_focc(jnp.asarray(bwt.astype(np.int32)), sigma)
    f_new = build_focc_host(bwt, sigma, chunk_rows=chunk)
    assert type(f_new) is type(f_ref)
    _assert_equivalent(f_ref, f_new, n, sigma, rng)


def test_chunked_occ_rows_byte_identical():
    # occ checkpoint words must match the monolithic layout exactly
    rng = np.random.default_rng(7)
    n, sigma = 262_144 + 37, 5
    bwt = rng.integers(0, sigma, n).astype(np.uint8)
    f_ref = build_focc(jnp.asarray(bwt.astype(np.int32)), sigma)
    f_new = build_focc_host(bwt, sigma, chunk_rows=128)
    nb = (n + 255) // 256
    ref = np.asarray(f_ref.rows)[: nb + 1]
    new = np.asarray(f_new.rows)[: nb + 1]
    # bit-plane rows: words 24..24+sigma hold the checkpoints
    ref_w = ref.reshape(nb + 1, 32, 4).view(np.uint32) \
        if ref.shape[1] == 128 else None
    assert ref_w is not None
    new_w = new.reshape(nb + 1, 32, 4).view(np.uint32)
    assert np.array_equal(ref_w[:, 24 : 24 + sigma], new_w[:, 24 : 24 + sigma])
    # plane words identical except inside the final partial block's padding
    assert np.array_equal(ref_w[:nb - 1, :24], new_w[:nb - 1, :24])


def test_chunked_unpadded_shape():
    rng = np.random.default_rng(3)
    n, sigma = 10_000, 5
    bwt = rng.integers(0, sigma, n).astype(np.uint8)
    f_ref = build_focc(jnp.asarray(bwt.astype(np.int32)), sigma,
                       pad_shape=False)
    f_new = build_focc_host(bwt, sigma, pad_shape=False)
    assert f_new.rows.shape == f_ref.rows.shape
    _assert_equivalent(f_ref, f_new, n, sigma, rng)


def test_chunked_empty():
    f = build_focc_host(np.zeros(0, np.uint8), 5)
    assert f.n == 0
    assert np.asarray(f.C).max() == 0

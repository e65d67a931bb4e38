"""FusedOcc (single-row-gather rank structure) vs the plain OccTable."""

import jax.numpy as jnp
import numpy as np
import pytest

from bwtb3m.ops.focc import (
    access_batch_f, backward_step_f, build_focc, lf_step_batch_f,
    rank_batch_f)


def _naive_rank(bwt, c, i):
    return int(np.count_nonzero(bwt[:i] == c))


def test_focc_rank_access_random():
    rng = np.random.default_rng(0)
    for n, sigma in ((1, 2), (7, 3), (300, 5), (512, 4), (5000, 6),
                     (4096, 5), (70000, 2)):
        bwt = rng.integers(0, sigma, n).astype(np.int8)
        focc = build_focc(bwt, sigma)
        q = rng.integers(0, n + 1, 257).astype(np.uint32)
        q[0] = n  # regression: i == n must read the total-count row
        q[1] = 0
        c = rng.integers(0, sigma, 257).astype(np.int32)
        got = np.asarray(rank_batch_f(focc, jnp.asarray(c), jnp.asarray(q)))
        for j in range(len(q)):
            assert got[j] == _naive_rank(bwt, c[j], int(q[j])), (n, j)
        qa = rng.integers(0, n, 129).astype(np.uint32)
        acc = np.asarray(access_batch_f(focc, jnp.asarray(qa)))
        assert np.array_equal(acc, bwt[qa.astype(np.int64)])


def test_focc_lf_matches_occtable():
    from bwtb3m.ops.lf import lf_step_batch
    from bwtb3m.ops.rank import build_occ
    rng = np.random.default_rng(1)
    n, sigma = 4096, 5
    bwt = rng.integers(0, sigma, n).astype(np.int32)
    occt = build_occ(bwt, sigma)
    focc = build_focc(bwt, sigma)
    r = rng.integers(0, n, 1024).astype(np.uint32)
    s1, r1 = lf_step_batch(occt, jnp.asarray(r.astype(np.int32)))
    s2, r2 = lf_step_batch_f(focc, jnp.asarray(r))
    assert np.array_equal(np.asarray(s1), np.asarray(s2))
    assert np.array_equal(np.asarray(r1).astype(np.uint32), np.asarray(r2))


def test_focc_backward_search_counts():
    rng = np.random.default_rng(2)
    n, sigma = 2000, 4
    from oracle import naive_circular_sa
    text = rng.integers(0, sigma, n).astype(np.int32)
    sa = naive_circular_sa(text)
    bwt = text[(sa - 1) % n]
    focc = build_focc(bwt, sigma)
    for _ in range(50):
        k = int(rng.integers(1, 8))
        pat = rng.integers(0, sigma, k)
        lo = jnp.zeros(1, jnp.uint32)
        hi = jnp.full(1, n, jnp.uint32)
        for c in pat[::-1]:
            lo, hi = backward_step_f(
                focc, jnp.full(1, int(c), jnp.int32), lo, hi)
        count = int(np.asarray(hi)[0]) - int(np.asarray(lo)[0])
        # circular occurrence count
        ext = np.concatenate([text, text[: k - 1]]) if k > 1 else text
        win = np.lib.stride_tricks.sliding_window_view(ext, k)
        expect = int(np.sum(np.all(win == pat, axis=1)))
        assert count == expect


@pytest.mark.slow
def test_focc_bitplane_vs_byterow():
    """The sigma<=8 bit-plane structure (ops/focc_bp.py) must agree with
    the byte-row FusedOcc on every query type, including i == n and the
    padded tail block."""
    from bwtb3m.ops.focc import BLOCK, _build_focc_jax, _pad_rows
    from bwtb3m.ops.focc_bp import (
        access_batch_bp, backward_step_bp, build_focc_bp, lf_step_batch_bp,
        rank_batch_bp)

    rng = np.random.default_rng(7)
    for n, sigma in ((1, 2), (255, 2), (256, 8), (257, 7), (5000, 5),
                     (65536, 4), (70001, 8)):
        bwt = rng.integers(0, sigma, n).astype(np.int8)
        nb = max(1, (n + BLOCK - 1) // BLOCK)
        legacy = _build_focc_jax(jnp.asarray(bwt), sigma, BLOCK,
                                 _pad_rows(nb + 1))
        bp = build_focc_bp(jnp.asarray(bwt), sigma)
        q = rng.integers(0, n + 1, 513).astype(np.uint32)
        q[0] = n
        q[1] = 0
        c = rng.integers(0, sigma, 513).astype(np.int32)
        qj, cj = jnp.asarray(q), jnp.asarray(c)
        assert np.array_equal(np.asarray(rank_batch_f(legacy, cj, qj)),
                              np.asarray(rank_batch_bp(bp, cj, qj))), (n, sigma)
        qa = jnp.asarray(rng.integers(0, n, 257).astype(np.uint32))
        assert np.array_equal(np.asarray(access_batch_f(legacy, qa)),
                              np.asarray(access_batch_bp(bp, qa)))
        r = jnp.asarray(rng.integers(0, n, 257).astype(np.uint32))
        s1, r1 = lf_step_batch_f(legacy, r)
        s2, r2 = lf_step_batch_bp(bp, r)
        assert np.array_equal(np.asarray(s1), np.asarray(s2))
        assert np.array_equal(np.asarray(r1), np.asarray(r2))
        lo = jnp.asarray(rng.integers(0, n, 65).astype(np.uint32))
        hi = jnp.asarray(np.minimum(np.asarray(lo) + 37, n).astype(np.uint32))
        cs = jnp.asarray(rng.integers(0, sigma, 65).astype(np.int32))
        l1, h1 = backward_step_f(legacy, cs, lo, hi)
        l2, h2 = backward_step_bp(bp, cs, lo, hi)
        assert np.array_equal(np.asarray(l1), np.asarray(l2))
        assert np.array_equal(np.asarray(h1), np.asarray(h2))


def test_lf_step_fused_two_stage_matches():
    # lf_step_batch_bp2 (two-reduction fused arithmetic) must equal the
    # naive composition on every rank
    import numpy as np
    from bwtb3m.ops.focc_bp import (build_focc_bp, lf_step_batch_bp,
                                        lf_step_batch_bp2)
    rng = np.random.default_rng(41)
    for sigma in (2, 5, 8):
        n = 70_000 + sigma
        bwt = rng.integers(0, sigma, n).astype(np.int32)
        focc = build_focc_bp(jnp.asarray(bwt), sigma)
        r = jnp.asarray(rng.integers(0, n, 4096).astype(np.uint32))
        s1, r1 = lf_step_batch_bp(focc, r)
        s2, r2 = lf_step_batch_bp2(focc, r)
        assert np.array_equal(np.asarray(s1), np.asarray(s2))
        assert np.array_equal(np.asarray(r1), np.asarray(r2))

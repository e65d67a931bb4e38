"""Bidirectional FM index (index/bidir.py) vs brute-force rotation
oracles: synchronized forward/reverse intervals under left AND right
extensions."""

import numpy as np
import pytest

jnp = pytest.importorskip("jax.numpy")

from bwtb3m.index.bidir import BidirectionalFMIndex
from oracle import naive_circular_sa


def _interval_oracle(text, w):
    """(lo, size) of rotations of circular `text` prefixed by w."""
    n = len(text)
    sa = naive_circular_sa(np.asarray(text, np.int64))
    hits = [r for r in range(n)
            if all(text[(sa[r] + i) % n] == w[i] for i in range(len(w)))]
    if not hits:
        return None, 0
    assert hits == list(range(hits[0], hits[-1] + 1))
    return hits[0], len(hits)


@pytest.mark.parametrize("seed,n,sigma", [(3, 60, 3), (5, 90, 4)])
def test_bidir_intervals_synchronized(seed, n, sigma):
    rng = np.random.default_rng(seed)
    text = rng.integers(0, sigma, n).astype(np.int32)
    rev = text[::-1].copy()
    idx = BidirectionalFMIndex.from_text(text, sigma)
    for _ in range(25):
        m = int(rng.integers(1, 6))
        w = [int(c) for c in rng.integers(0, sigma, m)]
        lo, lo_rev, size = idx.interval(np.array(w))
        olo, osz = _interval_oracle(text, w)
        assert size == osz
        if osz:
            assert lo == olo
            # synchronized reverse interval: reverse(w) in reverse text
            rlo, rsz = _interval_oracle(rev, w[::-1])
            assert rsz == osz and lo_rev == rlo


def test_bidir_left_right_equivalence():
    rng = np.random.default_rng(11)
    sigma, n = 4, 70
    text = rng.integers(0, sigma, n).astype(np.int32)
    idx = BidirectionalFMIndex.from_text(text, sigma)
    for _ in range(20):
        m = int(rng.integers(1, 6))
        w = rng.integers(0, sigma, m)
        assert idx.count(w) == idx.count(w, from_right=True)


def test_bidir_mixed_extension_order():
    # grow a window outward in alternating directions; the result must
    # equal the interval of the final string
    rng = np.random.default_rng(13)
    sigma, n = 3, 50
    text = rng.integers(0, sigma, n).astype(np.int32)
    rev = text[::-1].copy()
    idx = BidirectionalFMIndex.from_text(text, sigma)
    for _ in range(15):
        mid = int(rng.integers(0, sigma))
        w = [mid]
        lo, lo_rev, size = idx.whole(1)
        lo, lo_rev, size = idx.extend_left(jnp.asarray([mid]), lo, lo_rev,
                                           size)
        for _step in range(4):
            c = int(rng.integers(0, sigma))
            if rng.random() < 0.5:
                lo, lo_rev, size = idx.extend_left(
                    jnp.asarray([c]), lo, lo_rev, size)
                w = [c] + w
            else:
                lo, lo_rev, size = idx.extend_right(
                    jnp.asarray([c]), lo, lo_rev, size)
                w = w + [c]
        olo, osz = _interval_oracle(text, w)
        assert int(np.asarray(size)[0]) == osz
        if osz:
            assert int(np.asarray(lo)[0]) == olo
            rlo, rsz = _interval_oracle(rev, w[::-1])
            assert int(np.asarray(lo_rev)[0]) == rlo


def test_rank_all_matches_per_symbol():
    from bwtb3m.ops.focc_bp import (build_focc_bp, rank_all_batch_bp,
                                        rank_batch_bp)
    rng = np.random.default_rng(17)
    for sigma in (2, 5, 8):
        n = 50_000
        bwt = rng.integers(0, sigma, n).astype(np.int32)
        focc = build_focc_bp(jnp.asarray(bwt), sigma)
        i = jnp.asarray(rng.integers(0, n + 1, 1024).astype(np.uint32))
        allr = np.asarray(rank_all_batch_bp(focc, i))
        for c in range(sigma):
            one = np.asarray(rank_batch_bp(
                focc, jnp.full(1024, c, jnp.int32), i))
            assert np.array_equal(allr[:, c], one), (sigma, c)

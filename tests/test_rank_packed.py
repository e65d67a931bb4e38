import numpy as np
import pytest

from bwtb3m.ops.rank import (OccTable, access_batch, build_occ,
                                 rank_batch)
from bwtb3m.ops.rank_packed import (access_batch_packed, build_occ_packed,
                                        lf_step_batch_packed,
                                        rank_batch_packed)
from bwtb3m.ops.lf import lf_step_batch
from oracle import random_string

import jax.numpy as jnp


@pytest.mark.parametrize("sigma", [2, 4, 5, 17, 256])
@pytest.mark.parametrize("n", [1, 100, 128, 129, 1000])
def test_packed_matches_plain(sigma, n):
    bwt = random_string(n, sigma, seed=n * 13 + sigma)
    plain = build_occ(bwt, sigma)
    packed = build_occ_packed(bwt, sigma)
    rng = np.random.default_rng(0)
    i = jnp.asarray(rng.integers(0, n + 1, 64).astype(np.int32))
    c = jnp.asarray(rng.integers(0, sigma, 64).astype(np.int32))
    np.testing.assert_array_equal(
        np.asarray(rank_batch_packed(packed, c, i)),
        np.asarray(rank_batch(plain, c, i)))
    ia = jnp.asarray(rng.integers(0, n, 64).astype(np.int32))
    np.testing.assert_array_equal(
        np.asarray(access_batch_packed(packed, ia)),
        np.asarray(access_batch(plain, ia)))
    np.testing.assert_array_equal(np.asarray(packed.C), np.asarray(plain.C))


def test_packed_lf_walk_matches():
    bwt = random_string(5000, 4, seed=3)
    plain = build_occ(bwt, 4)
    packed = build_occ_packed(bwt, 4)
    r = jnp.asarray(np.arange(0, 5000, 37).astype(np.int32))
    for _ in range(5):
        s1, r1 = lf_step_batch(plain, r)
        s2, r2 = lf_step_batch_packed(packed, r)
        np.testing.assert_array_equal(np.asarray(s1), np.asarray(s2))
        np.testing.assert_array_equal(np.asarray(r1), np.asarray(r2))
        r = r1


def test_dispatch_via_free_functions():
    bwt = random_string(1000, 4, seed=5)
    packed = build_occ_packed(bwt, 4)
    i = jnp.asarray(np.array([0, 1, 500, 1000], np.int32))
    c = jnp.asarray(np.array([0, 1, 2, 3], np.int32))
    ref = np.array([int(np.count_nonzero(bwt[:k] == cc))
                    for cc, k in zip([0, 1, 2, 3], [0, 1, 500, 1000])])
    np.testing.assert_array_equal(np.asarray(rank_batch(packed, c, i)), ref)

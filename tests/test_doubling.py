"""Suffix sorter correctness vs brute-force rotation sort.

Mirrors the reference's exhaustive-tiny + random test style
(/root/reference/src/lcpbit.cpp testnk/testrandomn, SURVEY.md section 4.1).
"""

import numpy as np
import pytest

from bwtb3m.ops.doubling import suffix_array
from oracle import all_strings, naive_bwt, naive_circular_sa, random_string


def _check(text):
    text = np.asarray(text, dtype=np.int32)
    sigma = int(text.max()) + 1 if len(text) else 1
    sa, isa, bwt = suffix_array(text, sigma)
    np.testing.assert_array_equal(sa, naive_circular_sa(text))
    np.testing.assert_array_equal(bwt, naive_bwt(text))
    np.testing.assert_array_equal(isa[sa], np.arange(len(text)))


@pytest.mark.parametrize("length,sigma", [(1, 2), (2, 2), (3, 2), (6, 2), (4, 3)])
def test_exhaustive_tiny(length, sigma):
    for s in all_strings(length, sigma):
        _check(s)


def test_abbab():
    # the reference's fixed tiny case "abbab#" (lcpbit.cpp:4053)
    s = np.array([ord(c) for c in "abbab#"], dtype=np.int32)
    _check(s)


@pytest.mark.parametrize("n", [10, 100, 500, 1000])
@pytest.mark.parametrize("sigma", [2, 4, 8, 100])
def test_random(n, sigma):
    _check(random_string(n, sigma, seed=n * 1000 + sigma))


def test_periodic():
    # periodic texts keep tied rotations: BWT must still be correct and SA
    # deterministic (ties by position)
    for s in ["abab", "aaaa", "abcabcabc", "aabaab"]:
        _check(np.array([ord(c) for c in s], dtype=np.int32))


def test_banana():
    _check(np.frombuffer(b"banana", dtype=np.uint8).astype(np.int32))


def test_large_alphabet_bytes():
    _check(random_string(300, 256, seed=7))


def test_long_runs():
    s = np.concatenate([np.zeros(200, np.int32), np.ones(100, np.int32),
                        np.zeros(50, np.int32), [2]])
    _check(s)


def test_ls_matches_jax_variant():
    """The tie-compacted engine path and the single-graph variant agree."""
    import jax.numpy as jnp
    from bwtb3m.ops.doubling import (bwt_from_sa, suffix_array_jax,
                                         suffix_array_ls)
    for seed, sigma in [(0, 4), (1, 2), (2, 256)]:
        text = random_string(700, sigma, seed=seed)
        sa1, _ = suffix_array_jax(jnp.asarray(text), sigma)
        sa2, bwt2 = suffix_array_ls(text, sigma)
        np.testing.assert_array_equal(np.asarray(sa1), np.asarray(sa2))
        np.testing.assert_array_equal(
            np.asarray(bwt_from_sa(jnp.asarray(text), sa1)),
            np.asarray(bwt2))

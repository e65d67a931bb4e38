"""ops/idx64: uint32 gather/scatter correctness, including past 2^31.

The >2^31 case: jnp.take with int32
indices silently corrupts every text position past 2^31 in the region
derive (engine/merge_scaled.py). A raw lax.gather with uint32 indices is
the fix; these tests pin its semantics (big-array case kept to a handful
of elements read out of a 2^31+4k buffer — ~2 GB transient, CPU only).
"""

import numpy as np
import pytest
import jax.numpy as jnp

from bwtb3m.ops.idx64 import scatter_set_u32, take_u32


def test_take_u32_small():
    arr = jnp.asarray(np.arange(100, dtype=np.int8))
    idx = jnp.asarray(np.array([0, 3, 99, 50], np.uint32))
    out = np.asarray(take_u32(arr, idx))
    assert out.tolist() == [0, 3, 99, 50]


def test_take_u32_rows():
    arr = jnp.asarray(np.arange(24, dtype=np.int32).reshape(6, 4))
    idx = jnp.asarray(np.array([[5, 0], [2, 2]], np.uint32))
    out = np.asarray(take_u32(arr, idx))
    assert out.shape == (2, 2, 4)
    assert out[0, 0].tolist() == [20, 21, 22, 23]
    assert out[1, 1].tolist() == [8, 9, 10, 11]


def test_take_u32_clip():
    arr = jnp.asarray(np.array([7, 8, 9], np.int32))
    idx = jnp.asarray(np.array([0xFFFFFFFF, 1], np.uint32))
    out = np.asarray(take_u32(arr, idx))
    assert out[1] == 8  # index 0: clipped somewhere in range, value defined
    assert out[0] in (7, 8, 9)


def test_scatter_set_u32_drop():
    out = jnp.zeros(8, jnp.uint32)
    idx = jnp.asarray(np.array([2, 5, 100, 0xFFFFFFFF], np.uint32))
    vals = jnp.asarray(np.array([11, 12, 13, 14], np.uint32))
    res = np.asarray(scatter_set_u32(out, idx, vals))
    assert res.tolist() == [0, 0, 11, 0, 0, 12, 0, 0]


@pytest.mark.slow
def test_take_u32_past_2g():
    n = (1 << 31) + 4096
    x = np.zeros(n, np.int8)
    probes = np.array([3, (1 << 31) - 1, (1 << 31), (1 << 31) + 4095],
                      np.uint32)
    for i, p in enumerate(probes):
        x[int(p)] = i + 1
    out = np.asarray(take_u32(jnp.asarray(x), jnp.asarray(probes)))
    assert out.tolist() == [1, 2, 3, 4]

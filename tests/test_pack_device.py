import numpy as np
import pytest
import jax.numpy as jnp

from bwtb3m.io import compact
from bwtb3m.ops.pack import (load_compact_to_device, pack_bits_device,
                                 unpack_bits_device)


@pytest.mark.parametrize("bits", [1, 2, 3, 4, 5, 8])
def test_device_unpack_matches_host(bits):
    rng = np.random.default_rng(bits)
    n = 999
    sym = rng.integers(0, 1 << bits, n, dtype=np.int32)
    packed = compact.pack_bits(sym, bits)
    out = np.asarray(unpack_bits_device(jnp.asarray(packed), bits, n))
    np.testing.assert_array_equal(out, sym)


@pytest.mark.parametrize("bits", [1, 2, 4, 8, 3])
def test_device_pack_roundtrip(bits):
    rng = np.random.default_rng(bits + 10)
    n = 960  # byte-aligned for all tested widths
    sym = rng.integers(0, 1 << bits, n, dtype=np.int32)
    packed_dev = np.asarray(pack_bits_device(jnp.asarray(sym), bits))
    packed_host = compact.pack_bits(sym, bits)
    np.testing.assert_array_equal(packed_dev, packed_host)


def test_load_compact_to_device(tmp_path):
    rng = np.random.default_rng(0)
    sym = rng.integers(0, 8, 1234, dtype=np.int32)
    p = str(tmp_path / "x.compact")
    compact.write_compact(p, sym, 3)
    dev, bits = load_compact_to_device(p)
    assert bits == 3
    np.testing.assert_array_equal(np.asarray(dev), sym)

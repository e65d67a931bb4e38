"""Device-resident PLCP path (lcp/plcp.py compute_plcp_device +
encode_plcp_bits_device) vs the host oracle."""

import numpy as np
import pytest

import jax.numpy as jnp

from bwtb3m.lcp.plcp import (PLCPBitDecoder, compute_plcp_device,
                                 encode_plcp_bits, encode_plcp_bits_device,
                                 kasai_plcp, write_plcp_bytes)


def _sa_dev(text, sigma):
    from bwtb3m.ops.doubling import suffix_array
    sa, _isa, _bwt = suffix_array(text, sigma)
    return jnp.asarray(np.asarray(sa).astype(np.uint32))


@pytest.mark.parametrize("kind", ["random", "repetitive", "runs"])
def test_plcp_device_matches_oracle(kind):
    rng = np.random.default_rng(len(kind))
    n = 5000
    if kind == "random":
        text = rng.integers(0, 4, n).astype(np.int32)
    elif kind == "repetitive":
        seg = rng.integers(0, 4, 61)
        text = np.tile(seg, n // 61 + 1)[:n].astype(np.int32)
        text[rng.integers(0, n, 25)] = rng.integers(0, 4, 25)
    else:
        text = np.repeat(rng.integers(0, 4, n // 40 + 1), 40)[:n]\
            .astype(np.int32)
    sa_dev = _sa_dev(text, 4)
    plcp_dev = compute_plcp_device(text, 4, sa_dev, lanes=128)
    got = np.asarray(plcp_dev).astype(np.int64)
    want = kasai_plcp(text, np.asarray(sa_dev).astype(np.int64))
    assert np.array_equal(got, want)


def test_encode_device_matches_host(tmp_path):
    rng = np.random.default_rng(3)
    n = 3000
    text = rng.integers(0, 4, n).astype(np.int32)
    sa_dev = _sa_dev(text, 4)
    plcp_dev = compute_plcp_device(text, 4, sa_dev, lanes=64)
    plcp = np.asarray(plcp_dev).astype(np.int64)
    nbits, by = encode_plcp_bits_device(plcp_dev)
    bits_host = encode_plcp_bits(plcp)
    assert nbits == len(bits_host)
    got_bits = np.unpackbits(by, bitorder="little")[:nbits]
    assert np.array_equal(got_bits, bits_host)
    path = str(tmp_path / "t.lcpbit")
    write_plcp_bytes(path, n, nbits, by)
    dec = PLCPBitDecoder(path, n=n)
    assert np.array_equal(dec.all(), plcp)


def test_compute_sa_device(tmp_path):
    """engine.ssa.compute_sa_device returns the full SA on device."""
    from bwtb3m.engine import BwtOptions, compute_bwt
    from bwtb3m.engine.ssa import compute_sa_device

    rng = np.random.default_rng(9)
    data = rng.integers(97, 101, 4096, dtype=np.uint8)
    inp = str(tmp_path / "t.bin")
    data.tofile(inp)
    res = compute_bwt(BwtOptions(input_path=inp, bwt_only=True,
                                 preisa_sampling_rate=256, verbose=0))
    sa_dev, n = compute_sa_device(res.bwt_path)
    from tests.oracle import naive_circular_sa
    want = naive_circular_sa(data.astype(np.int32))
    assert np.array_equal(np.asarray(sa_dev).astype(np.int64), want)

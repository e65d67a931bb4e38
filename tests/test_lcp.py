import numpy as np
import pytest

from bwtb3m.lcp.plcp import (PLCPBitDecoder, compute_plcp,
                                 decode_plcp_bits, encode_plcp_bits,
                                 kasai_plcp, write_plcp_file)
from bwtb3m.lcp.rmm import RMMTree
from oracle import all_strings, naive_circular_sa, random_string


def _ref_plcp(text):
    return kasai_plcp(text, naive_circular_sa(text))


@pytest.mark.parametrize("s", ["abbab#", "banana", "mississippi", "aaaa",
                               "abababab"])
def test_plcp_small_strings(s):
    text = np.array([ord(c) for c in s], dtype=np.int32)
    plcp, sa = compute_plcp(text)
    np.testing.assert_array_equal(sa, naive_circular_sa(text))
    np.testing.assert_array_equal(plcp, _ref_plcp(text))


def test_plcp_exhaustive_tiny():
    for s in all_strings(5, 2):
        plcp, _sa = compute_plcp(s, 2)
        np.testing.assert_array_equal(plcp, _ref_plcp(s), err_msg=str(s))


@pytest.mark.parametrize("n,sigma", [(100, 2), (500, 4), (1000, 8), (2000, 256)])
def test_plcp_random(n, sigma):
    text = random_string(n, sigma, seed=n * 7 + sigma)
    plcp, _sa = compute_plcp(text, sigma)
    np.testing.assert_array_equal(plcp, _ref_plcp(text))


def test_plcp_succinct_roundtrip(tmp_path):
    text = random_string(700, 4, seed=1)
    plcp, _ = compute_plcp(text, 4)
    bits = encode_plcp_bits(plcp)
    assert len(bits) <= 2 * len(text) + int(plcp[0]) + 1
    np.testing.assert_array_equal(decode_plcp_bits(bits, len(plcp)), plcp)
    path = str(tmp_path / "x.lcpbit")
    write_plcp_file(path, plcp)
    dec = PLCPBitDecoder(path, n=len(text))
    np.testing.assert_array_equal(dec.all(), plcp)


def test_rmm_tree(tmp_path):
    rng = np.random.default_rng(0)
    vals = rng.integers(0, 100, size=233)
    t = RMMTree(vals)
    for l, r in [(0, 233), (0, 1), (100, 101), (7, 200), (50, 64)]:
        v, i = t.rmq(l, r)
        assert v == vals[l:r].min()
        assert i == l + int(np.argmin(vals[l:r]))
        assert vals[i] == v
    path = str(tmp_path / "x.rmm")
    t.write(path)
    t2 = RMMTree.read(path)
    assert t2.rmq(7, 200) == t.rmq(7, 200)


@pytest.mark.slow
def test_lcpbit_selftest_harness():
    from bwtb3m.lcp.selftest import testn, testnk, testrandomn
    testn([ord(c) for c in "abbab#"])
    testnk(4, 2)
    testrandomn(512, 8, seed=3)


def test_plcp_scaled_matches_oracle():
    # O(n)-memory batched-Kasai path vs the Phi/Kasai host oracle
    import numpy as np
    from bwtb3m.lcp.plcp import compute_plcp_scaled, kasai_plcp
    rng = np.random.default_rng(13)
    for n, mk in ((5000, "r"), (3000, "p")):
        if mk == "r":
            text = rng.integers(0, 4, n).astype(np.int32)
        else:
            seg = rng.integers(0, 4, 61)
            text = np.tile(seg, n // 61 + 1)[:n].astype(np.int32)
            text[rng.integers(0, n, 30)] = rng.integers(0, 4, 30)
        plcp, sa = compute_plcp_scaled(text, 4, lanes=128)
        ref = kasai_plcp(text, sa)
        assert np.array_equal(plcp, ref), n


def test_plcp_byte_alphabet_scaled_and_device():
    # sigma <= 256 path: byte windows in the
    # word-window Kasai kernel, both the slab machine and the fully
    # device-resident path, vs the host Phi/Kasai oracle
    import numpy as np
    from bwtb3m.lcp.plcp import (compute_plcp_device,
                                     compute_plcp_scaled, kasai_plcp)
    from bwtb3m.ops.doubling import suffix_array
    import jax.numpy as jnp
    rng = np.random.default_rng(41)
    n = 4096
    # mixed text: DNA-like runs + full-byte metadata spans (sigma = 256)
    text = rng.integers(0, 4, n).astype(np.int32)
    meta = rng.integers(0, 256, n // 4).astype(np.int32)
    text[: n // 4] = meta
    text[0] = 255
    sigma = 256
    plcp, sa = compute_plcp_scaled(text, sigma, lanes=128)
    ref = kasai_plcp(text, sa)
    assert np.array_equal(plcp, ref)
    # slab-striped byte path
    plcp2, _ = compute_plcp_scaled(text, sigma, lanes=64,
                                   slab_positions=1024)
    assert np.array_equal(plcp2, ref)
    # device-resident byte path
    sa_d, _isa, _bwt = suffix_array(text, sigma)
    plcp3 = np.asarray(compute_plcp_device(
        text, sigma, jnp.asarray(np.asarray(sa_d), dtype=jnp.uint32),
        lanes=128))
    assert np.array_equal(plcp3.astype(np.int64), ref)


def test_plcp_wide_alphabet_rank_compaction():
    # sigma > 256 with <= 256 distinct symbols: compute_plcp rank-
    # compacts (monotonic remap preserves SA and LCP) and routes the
    # dense path (/root/reference/src/lcpbit.cpp:677-806)
    import numpy as np
    rng = np.random.default_rng(43)
    alpha = np.sort(rng.choice(1 << 20, size=100, replace=False))
    text = alpha[rng.integers(0, 100, 3000)].astype(np.int32)
    plcp, sa = compute_plcp(text, 1 << 20)
    np.testing.assert_array_equal(plcp, kasai_plcp(text, sa))


def test_plcp_scaled_slab_striping():
    # host-staged position slabs (device holds one slab of phi/isa/plcp +
    # the global text rows) must reproduce the single-slab result; also
    # exercises the precomputed (sa, isa) input that skips the doubling
    # sort at reference scale
    import numpy as np
    from bwtb3m.lcp.plcp import compute_plcp_scaled, kasai_plcp
    rng = np.random.default_rng(31)
    n = 7001
    text = rng.integers(0, 4, n).astype(np.int32)
    plcp, sa = compute_plcp_scaled(text, 4, lanes=64, slab_positions=1024)
    ref = kasai_plcp(text, sa)
    assert np.array_equal(plcp, ref)
    # precomputed sa/isa path
    isa = np.zeros(n, np.int64)
    isa[sa] = np.arange(n)
    plcp2, _ = compute_plcp_scaled(text, 4, lanes=64, sa_isa=(sa, isa),
                                   slab_positions=2048)
    assert np.array_equal(plcp2, ref)

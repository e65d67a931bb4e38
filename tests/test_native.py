"""Native C++ codecs vs their pure-Python implementations."""

import numpy as np
import pytest

from bwtb3m import native
from oracle import naive_circular_sa, random_string

pytestmark = pytest.mark.skipif(
    native.get_lib() is None, reason="no native toolchain available")


def test_native_lz4_roundtrip():
    rng = np.random.default_rng(0)
    for data in [b"", b"a", b"abcabcabc" * 500,
                 bytes(rng.integers(0, 4, 50000, dtype=np.uint8)),
                 bytes(rng.integers(0, 256, 10000, dtype=np.uint8))]:
        comp = native.lz4_compress(data)
        assert comp is not None
        back = native.lz4_decompress(comp, len(data))
        assert back == data


def test_native_lz4_cross_python():
    # native-compressed decodes with the pure-Python decoder and vice versa
    import os
    from bwtb3m.io import lz4io
    data = b"the quick brown fox " * 300
    comp_nat = native.lz4_compress(data)
    os.environ["BWTB3M_NO_NATIVE"] = "1"
    try:
        # force the pure-Python paths by bypassing the wrappers
        native_backup, native._lib, native._tried = native._lib, None, True
        py_back = lz4io.lz4_decompress_block(comp_nat, len(data))
        assert py_back == data
        comp_py = lz4io.lz4_compress_block(data)
    finally:
        native._lib = native_backup
        native._tried = True
        del os.environ["BWTB3M_NO_NATIVE"]
    assert native.lz4_decompress(comp_py, len(data)) == data


def test_native_gt0_matches_python():
    from bwtb3m.ops import gap
    for seed in range(5):
        text = random_string(300, 3, seed=seed)
        nat = native.gt0(text)
        # pure python path
        backup, native._lib, native._tried = native._lib, None, True
        try:
            py = gap.compute_gt0(text)
        finally:
            native._lib = backup
        np.testing.assert_array_equal(nat, py)


def test_native_kasai_matches_oracle():
    text = random_string(500, 4, seed=9)
    sa = naive_circular_sa(text)
    nat = native.kasai_plcp(text, sa)
    backup, native._lib, native._tried = native._lib, None, True
    try:
        from bwtb3m.lcp.plcp import kasai_plcp
        py = kasai_plcp(text, sa)
    finally:
        native._lib = backup
    np.testing.assert_array_equal(nat, py)


def test_native_sais_matches_circular_oracle_on_pacterm():
    # pacterm-style text (unique smallest terminator): circular rotation
    # order == suffix order of T$, so sais must equal the circular oracle
    rng = np.random.default_rng(7)
    for n in (1, 2, 17, 200, 1000):
        t = (rng.integers(1, 5, n)).astype(np.int32)
        t[-1] = 0  # unique terminator
        sa = native.sais(t)
        assert sa is not None
        ora = naive_circular_sa(t)
        assert np.array_equal(sa, ora)


def test_native_sais_plain_suffix_order():
    rng = np.random.default_rng(8)
    for n in (1, 5, 64, 500):
        for sigma in (1, 2, 4):
            t = rng.integers(0, sigma, n).astype(np.int32)
            sa = native.sais(t)
            expect = sorted(range(n), key=lambda i: (list(t[i:]) + [-1]))
            assert list(sa) == expect

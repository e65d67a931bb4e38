import numpy as np
import pytest

from bwtb3m.io import compact, formats, lz4io, pac, rl
from bwtb3m.io.inputtypes import (circular_reverse_slice, circular_slice,
                                      parse_input_type)


@pytest.mark.parametrize("bits", [1, 2, 3, 4, 5, 8])
def test_compact_roundtrip(tmp_path, bits):
    rng = np.random.default_rng(bits)
    for n in [0, 1, 7, 8, 63, 64, 65, 1000]:
        sym = rng.integers(0, 1 << bits, size=n, dtype=np.int32)
        path = str(tmp_path / f"c{bits}_{n}.compact")
        compact.write_compact(path, sym, bits)
        back, rbits = compact.read_compact(path)
        assert rbits == bits
        np.testing.assert_array_equal(back, sym)


def test_compact_writer_streaming(tmp_path):
    rng = np.random.default_rng(0)
    sym = rng.integers(0, 8, size=10013, dtype=np.int32)
    path = str(tmp_path / "s.compact")
    with compact.CompactArrayWriter(path, 3) as w:
        i = 0
        for chunk in [1, 10, 100, 1000, 5000, 3902, 1000]:
            w.put(sym[i : i + chunk])
            i += chunk
    back, bits = compact.read_compact(path)
    assert bits == 3
    np.testing.assert_array_equal(back, sym)


@pytest.mark.parametrize("sigma", [2, 4, 6, 256, 1000])
def test_rl_roundtrip(tmp_path, sigma):
    rng = np.random.default_rng(sigma)
    # runs of geometric length -> exercises escapes and block splits
    runs = rng.integers(0, sigma, size=500)
    lens = rng.geometric(0.02, size=500)
    sym = np.repeat(runs, lens).astype(np.int32)
    path = str(tmp_path / "x.bwt")
    rl.rl_encode(path, sym, sigma=sigma, block_size=257)
    assert rl.RLReader.get_length(path) == len(sym)
    with rl.RLReader(path) as r:
        np.testing.assert_array_equal(r.decode_all(), sym)
        # range decode
        for lo, hi in [(0, 10), (250, 600), (len(sym) - 5, len(sym)), (7, 7)]:
            np.testing.assert_array_equal(r.decode_range(lo, hi), sym[lo:hi])
        # rank vs numpy
        for c in [0, 1, sigma - 1]:
            for i in [0, 1, 256, 257, 258, len(sym) // 2, len(sym)]:
                assert r.rank(c, i) == int(np.count_nonzero(sym[:i] == c))
        hist = r.symbol_histogram()
        np.testing.assert_array_equal(
            hist.astype(np.int64), np.bincount(sym, minlength=sigma)
        )


def test_rl_iter_runs(tmp_path):
    sym = np.array([1, 1, 1, 2, 2, 0] * 100, dtype=np.int32)
    path = str(tmp_path / "r.bwt")
    rl.rl_encode(path, sym, sigma=3, block_size=7)  # force boundary splits
    with rl.RLReader(path) as r:
        runs = list(r.iter_runs())
    rebuilt = np.concatenate([[s] * l for s, l in runs])
    np.testing.assert_array_equal(rebuilt, sym)
    # runs must be maximal (merged across block boundaries)
    for (s1, _), (s2, _) in zip(runs, runs[1:]):
        assert s1 != s2


def test_lz4_roundtrip(tmp_path):
    rng = np.random.default_rng(1)
    for data in [
        b"",
        b"a",
        b"abcabcabcabc" * 100,
        bytes(rng.integers(0, 256, size=5000, dtype=np.uint8)),
        bytes(rng.integers(0, 4, size=70000, dtype=np.uint8)),
    ]:
        path = str(tmp_path / "x.lz4")
        lz4io.write_lz4_stream(path, data, block_size=1 << 12)
        assert lz4io.read_lz4_stream(path) == data


def test_pac_roundtrip(tmp_path):
    rng = np.random.default_rng(2)
    for n in [1, 3, 4, 5, 8, 1001]:
        codes = rng.integers(0, 4, size=n, dtype=np.int32)
        path = str(tmp_path / "x.pac")
        pac.write_pac(path, codes)
        np.testing.assert_array_equal(pac.read_pac(path), codes)


def test_formats_roundtrip(tmp_path):
    hist = {0: 5, 3: 10, 200: 1}
    hp = str(tmp_path / "x.hist")
    formats.write_hist(hp, hist)
    assert formats.read_hist(hp) == hist

    ranks = np.array([5, 1, 9], dtype=np.int64)
    poss = np.array([0, 64, 128], dtype=np.int64)
    pp = str(tmp_path / "x.preisa")
    formats.write_preisa(pp, ranks, poss, 64)
    r, p, rate = formats.read_preisa(pp)
    np.testing.assert_array_equal(r, ranks)
    np.testing.assert_array_equal(p, poss)
    assert rate == 64

    sp = str(tmp_path / "x.sa")
    vals = np.arange(17, dtype=np.int64) * 3
    formats.write_sampled_array(sp, 32, vals)
    rate, back = formats.read_sampled_array(sp)
    assert rate == 32
    np.testing.assert_array_equal(back, vals)


def test_input_types(tmp_path):
    # bytestream
    bs = tmp_path / "x.bytes"
    bs.write_bytes(b"banana")
    sym, sigma = parse_input_type("bytestream").load(str(bs))
    np.testing.assert_array_equal(sym, np.frombuffer(b"banana", np.uint8))
    assert sigma == 256
    # pacterm shifts bases to 1..4 and appends smallest-symbol terminator 0
    codes = np.array([0, 1, 2, 3, 0], dtype=np.int32)
    pp = tmp_path / "x.pac"
    pac.write_pac(str(pp), codes)
    sym, sigma = parse_input_type("pacterm").load(str(pp))
    np.testing.assert_array_equal(sym, np.concatenate([codes + 1, [0]]))
    assert sigma == 5
    # utf-8
    up = tmp_path / "x.txt"
    up.write_text("héllo")
    sym, sigma = parse_input_type("utf-8").load(str(up))
    assert sym.tolist() == [ord(c) for c in "héllo"]


def test_circular_slices():
    t = np.arange(10)
    np.testing.assert_array_equal(circular_slice(t, 8, 4), [8, 9, 0, 1])
    np.testing.assert_array_equal(circular_reverse_slice(t, 1, 4), [1, 0, 9, 8])

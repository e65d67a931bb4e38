import numpy as np
import pytest

from bwtb3m.io.bits import (GammaFile, gamma_decode, gamma_encode,
                                pack_bitstream, unpack_bitstream)
from bwtb3m.io.rl import open_bwt, rl_encode
from bwtb3m.io.rlh import RLHReader, rlh_decode, rlh_encode
from oracle import random_string


def test_gamma_roundtrip():
    rng = np.random.default_rng(0)
    vals = np.concatenate([
        [1, 2, 3, 4, 255, 256, 1 << 30],
        rng.integers(1, 1 << 20, 500),
    ]).astype(np.uint64)
    bits, nb = gamma_encode(vals)
    assert nb == len(bits)
    np.testing.assert_array_equal(gamma_decode(bits, len(vals)), vals)
    # byte stream roundtrip
    back = unpack_bitstream(pack_bitstream(bits), nb)
    np.testing.assert_array_equal(back, bits)


def test_gamma_file(tmp_path):
    vals = np.array([5, 1, 1, 9, 1000000], np.uint64)
    p = str(tmp_path / "x.gamma")
    GammaFile.write(p, vals)
    np.testing.assert_array_equal(GammaFile.read(p), vals)


def test_gamma_rejects_zero():
    with pytest.raises(ValueError):
        gamma_encode(np.array([0], np.uint64))


@pytest.mark.parametrize("sigma", [2, 4, 6, 200])
def test_rlh_roundtrip(tmp_path, sigma):
    rng = np.random.default_rng(sigma)
    runs = rng.integers(0, sigma, size=400)
    lens = rng.geometric(0.05, size=400)
    sym = np.repeat(runs, lens).astype(np.int32)
    p = str(tmp_path / "x.bwt")
    rlh_encode(p, sym, sigma=sigma, block_size=333)
    assert RLHReader.get_length(p) == len(sym)
    with RLHReader(p) as r:
        np.testing.assert_array_equal(r.decode_all(), sym)
        np.testing.assert_array_equal(
            r.symbol_histogram().astype(np.int64),
            np.bincount(sym, minlength=sigma))
        for c in (0, sigma - 1):
            for i in (0, 100, 333, 334, len(sym)):
                assert r.rank(c, i) == int(np.count_nonzero(sym[:i] == c))


def test_rlh_python_fallback_matches(tmp_path):
    from bwtb3m import native
    sym = np.repeat([0, 3, 1, 2, 1], [5, 1, 300, 7, 2]).astype(np.int32)
    p = str(tmp_path / "y.bwt")
    rlh_encode(p, sym, sigma=4)
    nat = rlh_decode(p)
    backup, native._lib, native._tried = native._lib, None, True
    try:
        py = rlh_decode(p)
    finally:
        native._lib = backup
    np.testing.assert_array_equal(nat, sym)
    np.testing.assert_array_equal(py, sym)


def test_open_bwt_dispatch(tmp_path):
    sym = random_string(1000, 4, seed=1)
    p1, p2 = str(tmp_path / "a.bwt"), str(tmp_path / "b.bwt")
    rl_encode(p1, sym, sigma=4)
    rlh_encode(p2, sym, sigma=4)
    with open_bwt(p1) as r1, open_bwt(p2) as r2:
        np.testing.assert_array_equal(r1.decode_all(), r2.decode_all())
    import os
    assert os.path.getsize(p2) < os.path.getsize(p1)


def test_engine_rlh_codec(tmp_path):
    from bwtb3m.engine import BwtOptions, check_bwt, compute_bwt
    data = bytes(random_string(2000, 4, seed=3).astype(np.uint8) + 97)
    inp = tmp_path / "t.bin"
    inp.write_bytes(data)
    res = compute_bwt(BwtOptions(input_path=str(inp), bwt_codec="rlh",
                                 preisa_sampling_rate=256, verbose=0))
    text = np.frombuffer(data, np.uint8).astype(np.int32)
    assert check_bwt(res, text)
    from oracle import naive_bwt
    np.testing.assert_array_equal(res.load_bwt(), naive_bwt(text))


def test_decoder_cli_rlh(tmp_path, capsysbinary):
    from bwtb3m.cli import dispatch
    sym = np.repeat([65, 66, 67], [10, 5, 20]).astype(np.int32)
    p = str(tmp_path / "r.bwt")
    rlh_encode(p, sym, sigma=256)
    assert dispatch(["bwtb3mdecoderl", p]) == 0
    out = capsysbinary.readouterr().out
    assert out == sym.astype(np.uint8).tobytes()


def test_rlh_empty_input_roundtrip(tmp_path):
    # the RLH codec must handle n == 0 like rl_encode does
    from bwtb3m.io.rlh import RLHReader
    p = str(tmp_path / "empty.bwt")
    rlh_encode(p, np.zeros(0, np.int32), sigma=4)
    with RLHReader(p) as r:
        assert r.n == 0
        assert len(r.decode_all()) == 0

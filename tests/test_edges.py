"""Edge cases and failure-path coverage."""

import numpy as np
import pytest

from bwtb3m.cli import dispatch
from bwtb3m.engine import BwtOptions, check_bwt, compute_bwt
from bwtb3m.io.rl import rl_encode
from bwtb3m.ops.doubling import suffix_array
from bwtb3m.parallel.dist import host_local_slice
from oracle import naive_bwt


def test_single_symbol_text(tmp_path):
    inp = tmp_path / "one.bin"
    inp.write_bytes(b"a")
    res = compute_bwt(BwtOptions(input_path=str(inp), verbose=0))
    np.testing.assert_array_equal(res.load_bwt(), [ord("a")])
    assert check_bwt(res, np.array([ord("a")], np.int32))


def test_two_symbols(tmp_path):
    inp = tmp_path / "two.bin"
    inp.write_bytes(b"ba")
    res = compute_bwt(BwtOptions(input_path=str(inp), verbose=0))
    np.testing.assert_array_equal(
        res.load_bwt(), naive_bwt(np.frombuffer(b"ba", np.uint8)))


def test_all_same_symbol(tmp_path):
    inp = tmp_path / "aaa.bin"
    inp.write_bytes(b"a" * 257)
    res = compute_bwt(BwtOptions(input_path=str(inp), verbose=0))
    np.testing.assert_array_equal(res.load_bwt(), [ord("a")] * 257)
    assert check_bwt(res, np.full(257, ord("a"), np.int32))


def test_checkbwt_cli_corruption_exit_code(tmp_path):
    rng = np.random.default_rng(1)
    data = bytes(rng.integers(97, 101, 500, dtype=np.uint8))
    inp = tmp_path / "c.bin"
    inp.write_bytes(data)
    assert dispatch(["bwtb3m", "verbose=0", str(inp)]) == 0
    # corrupt
    from bwtb3m.io.rl import rl_decode
    bwt = rl_decode(str(inp) + ".bwt")
    i = int(np.flatnonzero(bwt[1:] != bwt[:-1])[0])
    bwt[i], bwt[i + 1] = bwt[i + 1], bwt[i]
    rl_encode(str(inp) + ".bwt", bwt, sigma=256)
    assert dispatch(["checkbwt", "inputtype=bytestream", str(inp),
                     str(inp) + ".bwt"]) == 1


def test_decoder_utf8(tmp_path, capsysbinary):
    text = "héllo ünïcode"
    inp = tmp_path / "u.txt"
    inp.write_text(text, encoding="utf-8")
    assert dispatch(["bwtb3m", "inputtype=utf-8", "verbose=0", str(inp)]) == 0
    assert dispatch(["bwtb3mdecoderl", "format=utf-8", str(inp) + ".bwt"]) == 0
    out = capsysbinary.readouterr().out.decode("utf-8")
    codes = np.array([ord(c) for c in text], np.int32)
    expect = "".join(chr(int(c)) for c in naive_bwt(codes))
    assert out == expect


def test_host_local_slice():
    # single-process: whole range (divisibility trivially satisfied)
    assert host_local_slice(800) == slice(0, 800)
    assert host_local_slice(7) == slice(0, 7)


def test_suffix_array_empty():
    sa, isa, bwt = suffix_array(np.zeros(0, np.int32), 4)
    assert len(sa) == 0 and len(bwt) == 0

"""End-to-end construction over every input type the reference supports."""

import numpy as np

from bwtb3m.engine import BwtOptions, check_bwt, compute_bwt
from bwtb3m.io import compact
from bwtb3m.io.lz4io import write_lz4_stream
from bwtb3m.io.pac import write_pac
from oracle import naive_bwt, random_string


def _run(tmp_path, input_path, input_type, expect_text):
    res = compute_bwt(BwtOptions(input_path=str(input_path),
                                 input_type=input_type,
                                 preisa_sampling_rate=128, verbose=0))
    np.testing.assert_array_equal(res.load_bwt(), naive_bwt(expect_text))
    assert check_bwt(res, np.asarray(expect_text, np.int32))


def test_compactstream(tmp_path):
    sym = random_string(900, 8, seed=1)
    p = tmp_path / "x.compact"
    compact.write_compact(str(p), sym, 3)
    _run(tmp_path, p, "compactstream", sym)


def test_lz4(tmp_path):
    data = bytes(random_string(1200, 5, seed=2).astype(np.uint8) + 97)
    p = tmp_path / "x.lz4"
    write_lz4_stream(str(p), data, block_size=256)
    _run(tmp_path, p, "lz4", np.frombuffer(data, np.uint8).astype(np.int32))


def test_utf8(tmp_path):
    text = ("héllo wörld ünïcode çôdepoints " * 20) + "末端"
    p = tmp_path / "x.txt"
    p.write_text(text, encoding="utf-8")
    codes = np.array([ord(c) for c in text], dtype=np.int32)
    _run(tmp_path, p, "utf-8", codes)


def test_pac(tmp_path):
    codes = random_string(700, 4, seed=3)
    p = tmp_path / "x.pac"
    write_pac(str(p), codes)
    _run(tmp_path, p, "pac", codes)


def test_digits_roundtrip_through_engine(tmp_path):
    from bwtb3m.cli import dispatch
    txt = tmp_path / "d.txt"
    txt.write_text("1415926535897932384626433832795" * 10)
    out = str(tmp_path / "d.compact")
    assert dispatch(["digitsToCompact", "term=1", "outputfilename=" + out,
                     str(txt)]) == 0
    sym, _bits = compact.read_compact(out)
    _run(tmp_path, out, "compactstream", sym)

"""BGZF + BAM writer (io/bam.py, reference bambam::BamWriter role)."""

import gzip
import io
import struct

import numpy as np
import pytest

from bwtb3m.io.bam import (BGZFWriter, BamWriter, bgzf_decompress,
                               read_bam, reg2bin)


def test_bgzf_roundtrip_and_gzip_compat():
    rng = np.random.default_rng(0)
    payload = bytes(rng.integers(0, 256, 300000, dtype=np.uint8))
    buf = io.BytesIO()
    w = BGZFWriter(buf)
    w.write(payload)
    w.close()
    data = buf.getvalue()
    # our reader
    assert bgzf_decompress(data) == payload
    # independent check: every BGZF member is a valid gzip member, and the
    # stream ends with the fixed EOF block
    assert gzip.decompress(data) == payload
    assert data.endswith(bytes.fromhex(
        "1f8b08040000000000ff0600424302001b0003000000000000000000"))
    # BC subfields present with correct block sizes
    off = 0
    while off < len(data):
        assert data[off:off+4] == b"\x1f\x8b\x08\x04"
        (bsize,) = struct.unpack_from("<H", data, off + 16)
        off += bsize + 1
    assert off == len(data)


def test_bam_write_read_roundtrip(tmp_path):
    p = str(tmp_path / "t.bam")
    with open(p, "wb") as fh:
        w = BamWriter(fh, [("ref", 1000)], "@HD\tVN:1.6\n@SQ\tSN:ref\tLN:1000\n")
        w.write_record("r1", 0, 0, 41, 255, [(5, "M")], "ACGTA",
                       tags={"NM": 1, "MD": "3A1"})
        w.write_record("r2", 16, 0, 7, 255, [(4, "M")], "TTTT",
                       tags={"NM": 0, "MD": "4"})
        w.write_record("u1", 4, -1, -1, 0, [], "ACG")
        w.close()
    text, refs, recs = read_bam(p)
    assert refs == [("ref", 1000)]
    assert "SN:ref" in text
    assert [r["name"] for r in recs] == ["r1", "r2", "u1"]
    assert recs[0]["pos"] == 41 and recs[0]["flag"] == 0
    assert recs[0]["cigar"] == [(5, "M")] and recs[0]["seq"] == "ACGTA"
    assert recs[0]["tags"] == {"NM": 1, "MD": "3A1"}
    assert recs[1]["flag"] == 16 and recs[1]["tags"]["MD"] == "4"
    assert recs[2]["flag"] == 4 and recs[2]["ref_id"] == -1


def test_reg2bin_spec_examples():
    # values from the SAM spec binning scheme
    assert reg2bin(0, 1) == 4681
    assert reg2bin(0, 1 << 14) == 4681
    assert reg2bin(1 << 14, (1 << 14) + 1) == 4682
    assert reg2bin(0, (1 << 14) + 1) == 585


def test_allhamdna_bam_matches_sam(tmp_path, capsys):
    from bwtb3m.cli import dispatch as run
    from bwtb3m.io.pac import write_pac
    rng = np.random.default_rng(4)
    codes = rng.integers(0, 4, 600, dtype=np.int32)
    pacp = str(tmp_path / "h.pac")
    write_pac(pacp, codes)
    assert run(["bwtb3m", "inputtype=pacterm", "sasamplingrate=8",
                "isasamplingrate=8", "verbose=0", pacp]) == 0
    bases = "ACGT"
    read = list(bases[c] for c in codes[50:80])
    read[10] = bases[(codes[60] + 1) % 4]
    fa = str(tmp_path / "reads.fa")
    with open(fa, "w") as f:
        f.write(">r1\n%s\n>zz\n%s\n" % ("".join(read), "A" * 25))
    assert run(["allHamDna", "maxmis=1", pacp + ".bwt", fa]) == 0
    sam = [l for l in capsys.readouterr().out.splitlines()
           if l and not l.startswith("@")]
    bamp = str(tmp_path / "o.bam")
    assert run(["allHamDna", "maxmis=1", "obam=" + bamp,
                pacp + ".bwt", fa]) == 0
    _t, refs, recs = read_bam(bamp)
    assert refs[0][0] == "ref"
    assert len(recs) == len(sam)
    for line, rec in zip(sam, recs):
        f = line.split("\t")
        assert rec["name"] == f[0]
        assert rec["flag"] == int(f[1])
        if rec["flag"] != 4:
            assert rec["pos"] + 1 == int(f[3])   # SAM is 1-based
            assert "%dM" % rec["cigar"][0][0] == f[5]
            assert rec["seq"] == f[9]
            nm = [x for x in f if x.startswith("NM:i:")][0]
            md = [x for x in f if x.startswith("MD:Z:")][0]
            assert rec["tags"]["NM"] == int(nm[5:])
            assert rec["tags"]["MD"] == md[5:]

"""End-to-end CLI tests: drive the tools exactly as a user would."""

import gzip
import io
import sys

import numpy as np
import pytest

from bwtb3m.cli import dispatch
from bwtb3m.io import compact, formats
from bwtb3m.io.pac import write_pac
from oracle import naive_bwt, naive_circular_sa, random_string


def run(args):
    return dispatch(list(args))


def _write_fasta(path, seqs, gz=False):
    buf = []
    for name, seq in seqs:
        buf.append(">%s\n%s\n" % (name, seq))
    data = "".join(buf).encode()
    if gz:
        with gzip.open(path, "wb") as f:
            f.write(data)
    else:
        with open(path, "wb") as f:
            f.write(data)


def test_fagz_to_compact(tmp_path):
    fa = str(tmp_path / "x.fa.gz")
    _write_fasta(fa, [("s1", "ACGTN"), ("s2", "GGCC")], gz=True)
    out = str(tmp_path / "x.compact")
    assert run(["fagzToCompact", "rc=1", "outputfilename=" + out, fa]) == 0
    sym, bits = compact.read_compact(out)
    assert bits == 3
    # s1: ACGTN -> 1,2,3,4,5 term 0; rc(ACGTN) = NACGT -> 5,1,2,3,4 term 0
    # s1: ACGTN -> 1,2,3,4,5 |0|; rc = NACGT -> 5,1,2,3,4 |0|
    # s2: GGCC -> 3,3,2,2 |0|; rc(GGCC) = GGCC -> 3,3,2,2 |0|
    expect = [1, 2, 3, 4, 5, 0, 5, 1, 2, 3, 4, 0,
              3, 3, 2, 2, 0, 3, 3, 2, 2, 0]
    assert sym.tolist() == expect


def test_fagz_to_compact4_meta(tmp_path):
    fa = str(tmp_path / "y.fa")
    _write_fasta(fa, [("s1", "ACNNGT"), ("s2", "TTTT")])
    out = str(tmp_path / "y.c4")
    assert run(["fagzToCompact4", "outputfilename=" + out, "seed=7", fa]) == 0
    sym, bits = compact.read_compact(out)
    assert bits == 2 and len(sym) == 10
    from bwtb3m.cli.prep import read_compact4_meta
    meta = read_compact4_meta(out + ".meta")
    assert meta == [(6, [(2, 4)]), (4, [])]
    # non-N bases intact
    assert sym[:2].tolist() == [0, 1] and sym[4:6].tolist() == [2, 3]
    assert sym[6:].tolist() == [3, 3, 3, 3]


def test_fagz_uterm(tmp_path):
    fa = str(tmp_path / "z.fa")
    _write_fasta(fa, [("a", "AC"), ("b", "GT"), ("c", "AA")])
    out = str(tmp_path / "z.cu")
    assert run(["fagzToCompactUTerm", "outputfilename=" + out, fa]) == 0
    sym, bits = compact.read_compact(out)
    assert bits == 3
    # 3 seqs -> seqbits=2; bases +2; ids 00, 01, 10
    assert sym.tolist() == [2, 3, 0, 0, 4, 5, 0, 1, 2, 2, 1, 0]


def test_digits_to_compact(tmp_path):
    p = tmp_path / "d.txt"
    p.write_text("3141592653")
    out = str(tmp_path / "d.compact")
    assert run(["digitsToCompact", "term=1", "outputfilename=" + out, str(p)]) == 0
    sym, bits = compact.read_compact(out)
    assert bits == 4
    assert sym.tolist() == [4, 2, 5, 2, 6, 10, 3, 7, 6, 4, 0]


def test_full_pipeline_bwtb3m_checkbwt(tmp_path):
    data = bytes(random_string(2000, 4, seed=5).astype(np.uint8) + 97)
    inp = tmp_path / "t.bin"
    inp.write_bytes(data)
    assert run(["bwtb3m", "inputtype=bytestream", "sasamplingrate=16",
                "isasamplingrate=16", "verbose=0", str(inp)]) == 0
    assert run(["checkbwt", "inputtype=bytestream", str(inp),
                str(inp) + ".bwt"]) == 0
    # decode RL back to bytes: must equal oracle BWT
    from bwtb3m.io.rl import rl_decode
    text = np.frombuffer(data, np.uint8).astype(np.int32)
    np.testing.assert_array_equal(rl_decode(str(inp) + ".bwt"),
                                  naive_bwt(text))


def test_bwa_pipeline(tmp_path):
    codes = random_string(500, 4, seed=11)
    pacp = str(tmp_path / "g.pac")
    write_pac(pacp, codes)
    assert run(["bwtb3m", "inputtype=pacterm", "sasamplingrate=32",
                "isasamplingrate=32", "verbose=0", pacp]) == 0
    out_bwt = str(tmp_path / "bwa.bwt")
    out_sa = str(tmp_path / "bwa.sa")
    assert run(["bwtb3mtobwa", pacp + ".bwt", out_bwt, out_sa,
                "verbose=0"]) == 0
    from bwtb3m.index.bwa import read_bwa_bwt
    primary, L2, bases = read_bwa_bwt(out_bwt)
    assert len(bases) == 500


def test_converters(tmp_path):
    codes = random_string(400, 4, seed=2)
    pacp = str(tmp_path / "c.pac")
    write_pac(pacp, codes)
    assert run(["bwtb3m", "inputtype=pac", "verbose=0", pacp]) == 0
    bwt = pacp + ".bwt"
    assert run(["bwttohwt", bwt]) == 0
    assert run(["hwtToRlHwt", "verify=1", bwt]) == 0
    assert run(["bwttodnarank", bwt]) == 0
    assert run(["bwttodnarank256", "outputfilename=%s" % (bwt + ".dr256"), bwt]) == 0
    # hwt decodes to the bwt
    from bwtb3m.index.wavelet import HuffmanWaveletTree
    from bwtb3m.io.rl import rl_decode
    base = pacp
    wt = HuffmanWaveletTree.read(base + ".hwt")
    np.testing.assert_array_equal(wt.decode_all(), rl_decode(bwt))
    # dnarank rank matches
    from bwtb3m.index.dnarank import DNARank
    dr = DNARank.read(base + ".dnarank")
    bwtarr = rl_decode(bwt)
    assert dr.rank(2, 100) == int(np.count_nonzero(bwtarr[:100] == 2))


def test_ssa_tools(tmp_path):
    data = bytes(random_string(1500, 3, seed=8).astype(np.uint8) + 97)
    inp = tmp_path / "s.bin"
    inp.write_bytes(data)
    assert run(["bwtb3m", "bwtonly=1", "verbose=0", str(inp)]) == 0
    bwt = str(inp) + ".bwt"
    assert run(["bwtcomputessa", "sasamplingrate=16", "isasamplingrate=16",
                "verbose=0", bwt]) == 0
    text = np.frombuffer(data, np.uint8).astype(np.int32)
    sa = naive_circular_sa(text)
    rate, vals = formats.read_sampled_array(str(inp) + ".sa")
    np.testing.assert_array_equal(vals, sa[::16])
    # sortPreIsa + sasubsample
    assert run(["sortPreIsa", str(inp) + ".preisa", "verbose=0"]) == 0
    sub = str(tmp_path / "sub.sa")
    assert run(["sasubsample", "-s4", str(inp) + ".sa", sub]) == 0
    rate2, vals2 = formats.read_sampled_array(sub)
    assert rate2 == 64
    np.testing.assert_array_equal(vals2, vals[::4])
    # arraytocompact round trip (verify-on-write inside the tool)
    assert run(["arraytocompact", "verbose=0", str(inp) + ".sa"]) == 0


def test_bwtdecodeblock_and_decoder(tmp_path, capsysbinary):
    data = b"the quick brown fox jumps over the lazy dog " * 20
    inp = tmp_path / "q.bin"
    inp.write_bytes(data)
    assert run(["bwtb3m", "isasamplingrate=64", "sasamplingrate=8",
                "verbose=0", str(inp)]) == 0
    assert run(["bwtdecodeblock", "ref=" + str(inp), str(inp) + ".bwt",
                "100", "40"]) == 0
    out = capsysbinary.readouterr().out
    assert out == data[100:140]


def test_lcpbit_cli(tmp_path):
    data = bytes(random_string(600, 4, seed=13).astype(np.uint8) + 65)
    inp = tmp_path / "l.bin"
    inp.write_bytes(data)
    assert run(["bwtb3m", "verbose=0", str(inp)]) == 0
    bwt = str(inp) + ".bwt"
    assert run(["lcpbit", bwt]) == 0
    assert run(["checkLCPBit", str(inp) + ".lcpbit", bwt]) == 0
    assert run(["hwtToLCP", "checklcp=1", bwt]) == 0


def test_probescan_cli(tmp_path, capsys):
    rng = np.random.default_rng(0)
    codes = rng.integers(0, 4, 800, dtype=np.int32)
    pacp = str(tmp_path / "r.pac")
    write_pac(pacp, codes)
    assert run(["bwtb3m", "inputtype=pacterm", "verbose=0", pacp]) == 0
    # probe = an exact 20-mer from the reference
    bases = "ACGT"
    probe = "".join(bases[c] for c in codes[100:120])
    fa = str(tmp_path / "p.fa")
    _write_fasta(fa, [("p1", probe)])
    assert run(["probeScanDna", "mode=hwt", "k=20", pacp + ".bwt", fa]) == 0
    line = capsys.readouterr().out.strip().splitlines()[0]
    name, nk, matched, mean = line.split("\t")
    assert name == "p1" and int(nk) == 1 and int(matched) == 1


def test_allhamdna_cli(tmp_path, capsys):
    rng = np.random.default_rng(4)
    codes = rng.integers(0, 4, 600, dtype=np.int32)
    pacp = str(tmp_path / "h.pac")
    write_pac(pacp, codes)
    assert run(["bwtb3m", "inputtype=pacterm", "sasamplingrate=8",
                "isasamplingrate=8", "verbose=0", pacp]) == 0
    bases = "ACGT"
    read = list(bases[c] for c in codes[50:80])
    read[10] = bases[(codes[60] + 1) % 4]  # one mismatch
    fa = str(tmp_path / "reads.fa")
    _write_fasta(fa, [("r1", "".join(read))])
    assert run(["allHamDna", "maxmis=1", pacp + ".bwt", fa]) == 0
    out = capsys.readouterr().out
    lines = [l for l in out.splitlines() if l.startswith("r1")]
    hit = [l for l in lines if "\t51\t" in l and "NM:i:1" in l]
    assert hit, out


def test_unknown_tool():
    assert run(["nonsense"]) == 1


def test_probescan_occ_mode(tmp_path, capsys):
    rng = np.random.default_rng(7)
    codes = rng.integers(0, 4, 1000, dtype=np.int32)
    pacp = str(tmp_path / "o.pac")
    from bwtb3m.io.pac import write_pac as _wp
    _wp(pacp, codes)
    assert run(["bwtb3m", "inputtype=pacterm", "verbose=0", pacp]) == 0
    bases = "ACGT"
    probes = [("e1", "".join(bases[c] for c in codes[200:220])),
              ("e2", "".join(bases[(c + 1) % 4] for c in codes[200:230]))]
    fa = str(tmp_path / "probes.fa")
    _write_fasta(fa, probes)
    assert run(["probeScanDna", "mode=occ", "k=20", pacp + ".bwt", fa]) == 0
    out = capsys.readouterr().out.strip().splitlines()
    # occ mode counts must equal hwt mode counts
    assert run(["probeScanDna", "mode=hwt", "k=20", pacp + ".bwt", fa]) == 0
    out2 = capsys.readouterr().out.strip().splitlines()
    assert out[:2] == out2[:2]
    # exact probe found once
    assert out[0].split("\t")[2] == "1"


def test_every_tool_usage_line():
    """Arg-less invocation of every registered tool prints usage and exits
    nonzero without crashing (the whole 29-tool surface)."""
    from bwtb3m.cli import TOOLS, load_all
    load_all()
    assert len(TOOLS) >= 29, sorted(TOOLS)
    for name, fn in sorted(TOOLS.items()):
        if name == "lcpbit":
            continue  # bare `lcpbit` would print usage; `-test` runs long
        rc = dispatch([name])
        assert rc == 1, "tool %s should print usage and return 1, got %r" % (name, rc)


def test_probescan_words_mode(tmp_path, capsys):
    rng = np.random.default_rng(9)
    codes = rng.integers(0, 4, 600, dtype=np.int32)
    ref = str(tmp_path / "w.compact")
    compact.write_compact(ref, codes, 2)
    bases = "ACGT"
    probe = "".join(bases[c] for c in codes[100:115])
    fa = str(tmp_path / "wp.fa")
    _write_fasta(fa, [("w1", probe)])
    assert run(["probeScanDna", "mode=words", "k=15", ref, fa]) == 0
    line = capsys.readouterr().out.strip().splitlines()[0]
    _name, nk, matched, _mean = line.split("\t")
    assert int(nk) == 1 and int(matched) == 1


def test_allhamdna_unmapped_and_n_reads(tmp_path, capsys):
    rng = np.random.default_rng(21)
    codes = rng.integers(0, 4, 400, dtype=np.int32)
    pacp = str(tmp_path / "u.pac")
    write_pac(pacp, codes)
    assert run(["bwtb3m", "inputtype=pacterm", "sasamplingrate=8",
                "isasamplingrate=8", "verbose=0", pacp]) == 0
    fa = str(tmp_path / "ur.fa")
    _write_fasta(fa, [("miss", "A" * 25), ("withn", "ACGTN" * 5)])
    assert run(["allHamDna", "maxmis=0", pacp + ".bwt", fa]) == 0
    out = capsys.readouterr().out
    # the A-homopolymer read is almost surely unmapped (flag 4)
    assert any(l.startswith("miss\t4\t") for l in out.splitlines()) or \
        any(l.startswith("miss\t0\t") for l in out.splitlines())
    # reads containing N are skipped without crashing
    assert "withn" not in [l.split("\t")[0] for l in out.splitlines()
                           if "\t0\tref" in l]


def test_probescan_words_long_kmer(tmp_path, capsys):
    rng = np.random.default_rng(14)
    codes = rng.integers(0, 4, 2000, dtype=np.int32)
    ref = str(tmp_path / "lk.compact")
    compact.write_compact(ref, codes, 2)
    bases = "ACGT"
    probe = "".join(bases[c] for c in codes[500:545])  # k=45 > 31
    fa = str(tmp_path / "lk.fa")
    _write_fasta(fa, [("lk1", probe)])
    assert run(["probeScanDna", "mode=words", "k=45", ref, fa]) == 0
    line = capsys.readouterr().out.strip().splitlines()[0]
    _n, nk, matched, _m = line.split("\t")
    assert int(nk) == 1 and int(matched) == 1


def test_fa4suffixarraytocompact(tmp_path):
    # build a compact4 + .meta, then map sampled SA values to (seq, off)
    fa = str(tmp_path / "z.fa")
    _write_fasta(fa, [("s1", "ACGTAC"), ("s2", "GGTT")])
    c4 = str(tmp_path / "z.c4")
    assert run(["fagzToCompact4", "outputfilename=" + c4, fa]) == 0
    sa = str(tmp_path / "z.sa")
    # positions spanning both sequences + one past-the-end (terminator)
    values = np.array([0, 3, 5, 6, 9, 10], dtype=np.int64)
    formats.write_sampled_array(sa, 1, values)
    out = str(tmp_path / "z.fa4c")
    assert run(["fa4suffixarraytocompact", "outputfilename=" + out,
                sa, c4 + ".meta"]) == 0
    coords, _bits = compact.read_compact(out)
    # lens = [6, 4]; maxlen 6 -> obits = 3
    obits = 3
    expect = [(0 << obits) | 0, (0 << obits) | 3, (0 << obits) | 5,
              (1 << obits) | 0, (1 << obits) | 3, (2 << obits) | 0]
    assert coords.tolist() == expect


def test_fagz_bigband_layouts(tmp_path):
    from bwtb3m.cli.prep import _map_seq, _revcomp
    fa = str(tmp_path / "bb.fa")
    _write_fasta(fa, [("s1", "ACGT"), ("s2", "GGC")])
    s1 = _map_seq(b"ACGT")
    s2 = _map_seq(b"GGC")
    fwd = np.concatenate([s1, s2])
    out = str(tmp_path / "bb.c4bb")
    assert run(["fagzToCompact4BigBand", "outputfilename=" + out, fa]) == 0
    sym, bits = compact.read_compact(out)
    assert bits == 2
    # bigband: all sequences forward, then rc of the whole stream
    assert sym.tolist() == np.concatenate([fwd, _revcomp(fwd)]).tolist()
    out2 = str(tmp_path / "bb.c4bd")
    assert run(["fagzToCompact4BigBandBiDir", "outputfilename=" + out2,
                fa]) == 0
    sym2, _ = compact.read_compact(out2)
    # bidir: forward then rc per sequence
    expect = np.concatenate([s1, _revcomp(s1), s2, _revcomp(s2)])
    assert sym2.tolist() == expect.tolist()


def test_decodecompact_cli(tmp_path, capsysbinary):
    path = str(tmp_path / "d.compact")
    sym = np.array([3, 1, 4, 1, 5, 9, 2, 6], dtype=np.int64)
    compact.write_compact(path, sym, 4)
    assert run(["decodecompact", path]) == 0
    out = capsysbinary.readouterr().out
    assert list(out) == sym.tolist()


def test_bytestream_to_lz4_cli(tmp_path):
    from bwtb3m.io.lz4io import read_lz4_stream
    src = str(tmp_path / "s.bin")
    rng = np.random.default_rng(3)
    # compressible + random mix, multiple 64k blocks
    data = np.concatenate([
        np.zeros(70000, np.uint8),
        rng.integers(0, 256, 70000, dtype=np.uint8),
        np.tile(np.arange(256, dtype=np.uint8), 300),
    ])
    data.tofile(src)
    out = str(tmp_path / "s.lz4")
    assert run(["bytestreamToLz4", "outputfilename=" + out, src]) == 0
    back = np.frombuffer(read_lz4_stream(out), dtype=np.uint8)
    assert np.array_equal(back, data)


def test_bwttestdecodespeed_cli(tmp_path):
    # the throughput tool must run end-to-end on a real .bwt (tiny steps/
    # streams so the CPU test stays fast) and exit 0
    rng = np.random.default_rng(3)
    inp = tmp_path / "t.bin"
    inp.write_bytes(bytes(rng.integers(97, 101, 4096, dtype=np.uint8)))
    out = str(tmp_path / "t.bwt")
    assert run(["bwtb3m", "inputtype=bytestream", "bwtonly=1", "verbose=0",
                "outputfilename=" + out, str(inp)]) == 0
    assert run(["bwttestdecodespeed", "steps=64", "maxstreams=64",
                "verbose=0", out]) == 0

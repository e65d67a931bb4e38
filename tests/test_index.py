import io as _io

import numpy as np
import pytest

from bwtb3m.index.bitvector import RankBitVector, RLBitVector
from bwtb3m.index.bwa import read_bwa_bwt, read_bwa_sa, rewrite
from bwtb3m.index.dnarank import DNARank
from bwtb3m.index.fm import FMIndex
from bwtb3m.index.huffman import HuffmanTree
from bwtb3m.index.sampled import SampledSA
from bwtb3m.index.wavelet import HuffmanWaveletTree, RLHuffmanWaveletTree
from oracle import naive_bwt, naive_circular_sa, random_string


@pytest.mark.parametrize("cls", [RankBitVector, RLBitVector])
@pytest.mark.parametrize("n", [0, 1, 63, 64, 65, 512, 513, 3000])
def test_bitvector_rank(cls, n):
    rng = np.random.default_rng(n)
    bits = (rng.random(n) < 0.3).astype(np.uint8)
    bv = cls(bits)
    ref = np.concatenate([[0], np.cumsum(bits)])
    qs = np.arange(n + 1)
    np.testing.assert_array_equal(bv.rank1(qs), ref)
    np.testing.assert_array_equal(bv.rank0(qs), qs - ref)
    if n:
        np.testing.assert_array_equal(bv.get(np.arange(n)), bits)
    # serialization roundtrip
    buf = _io.BytesIO()
    bv.write(buf)
    buf.seek(0)
    bv2 = cls.read(buf)
    np.testing.assert_array_equal(bv2.rank1(qs), ref)


def test_huffman_prefix_free_and_deterministic():
    hist = {0: 5, 1: 5, 2: 3, 7: 100, 9: 1}
    t1, t2 = HuffmanTree(hist), HuffmanTree(dict(hist))
    assert t1.code == t2.code and t1.length == t2.length
    codes = [(t1.code[s], t1.length[s]) for s in t1.symbols]
    for i, (c1, l1) in enumerate(codes):
        for j, (c2, l2) in enumerate(codes):
            if i == j:
                continue
            if l1 <= l2:
                assert (c2 >> (l2 - l1)) != c1, "prefix violation"
    # rebuild from lengths matches
    t3 = HuffmanTree.from_lengths(t1.encode_lengths())
    assert t3.code == t1.code


def test_huffman_single_symbol():
    t = HuffmanTree({42: 10})
    assert t.length[42] == 1
    assert t.num_inner == 1


@pytest.mark.parametrize("cls", [HuffmanWaveletTree, RLHuffmanWaveletTree])
@pytest.mark.parametrize("sigma", [2, 5, 17, 200])
def test_wavelet_queries(tmp_path, cls, sigma):
    rng = np.random.default_rng(sigma)
    # skewed distribution -> non-trivial tree shape
    syms = rng.choice(sigma, p=_skew(sigma), size=2000).astype(np.int64)
    wt = cls.build(syms)
    np.testing.assert_array_equal(wt.decode_all(), syms)
    qs = np.array([0, 1, 7, 100, 999, 2000])
    for c in [0, sigma // 2, sigma - 1]:
        ref = np.array([np.count_nonzero(syms[:q] == c) for q in qs])
        np.testing.assert_array_equal(wt.rank(c, qs), ref)
    s, r = wt.inverse_select(np.arange(len(syms)))
    np.testing.assert_array_equal(s, syms)
    ref_r = np.array([np.count_nonzero(syms[:i] == syms[i])
                      for i in range(len(syms))])
    np.testing.assert_array_equal(r, ref_r)
    # file roundtrip
    path = str(tmp_path / "w.hwt")
    wt.write(path)
    wt2 = cls.read(path)
    np.testing.assert_array_equal(wt2.decode_all(), syms)
    np.testing.assert_array_equal(wt2.rank(sigma - 1, qs), wt.rank(sigma - 1, qs))


def _skew(sigma):
    p = 1.0 / (np.arange(sigma) + 1.0)
    return p / p.sum()


@pytest.mark.parametrize("block", [64, 256])
def test_dnarank(tmp_path, block):
    rng = np.random.default_rng(block)
    syms = rng.integers(0, 4, size=5000, dtype=np.uint8)
    dr = DNARank(syms, block=block)
    qs = np.array([0, 1, 63, 64, 65, 255, 256, 257, 2500, 5000])
    for c in range(4):
        ref = np.array([np.count_nonzero(syms[:q] == c) for q in qs])
        np.testing.assert_array_equal(dr.rank(c, qs), ref)
    np.testing.assert_array_equal(dr.symbol(np.arange(5000)), syms)
    path = str(tmp_path / "x.dnarank")
    dr.write(path)
    dr2 = DNARank.read(path)
    for c in range(4):
        np.testing.assert_array_equal(dr2.rank(c, qs), dr.rank(c, qs))


def _make_result(tmp_path, text, name="t", **kw):
    from bwtb3m.engine import BwtOptions, compute_bwt
    inp = tmp_path / (name + ".bin")
    inp.write_bytes(bytes(bytearray(np.asarray(text, np.uint8))))
    kw.setdefault("preisa_sampling_rate", 128)
    kw.setdefault("sa_sampling_rate", 8)
    kw.setdefault("isa_sampling_rate", 8)
    return compute_bwt(BwtOptions(input_path=str(inp), verbose=0, **kw))


def test_fm_index_search_locate_extract(tmp_path):
    text = random_string(800, 4, seed=3) + 97  # bytes a..d
    res = _make_result(tmp_path, text)
    fm = FMIndex.from_bwt_result(res, structure="hwt")
    sa = naive_circular_sa(text)
    # counts vs naive for random patterns
    rng = np.random.default_rng(0)
    for plen in [1, 2, 3, 5]:
        for _ in range(5):
            start = int(rng.integers(0, len(text) - plen))
            pat = text[start : start + plen]
            lo, hi = fm.backward_search(pat)
            naive = sum(
                1 for p in range(len(text))
                if np.array_equal(
                    np.take(text, (p + np.arange(plen)) % len(text)), pat)
            )
            assert hi - lo == naive
            # locate returns actual occurrence positions
            got = fm.locate_range(lo, hi)
            expect = np.sort(sa[lo:hi])
            np.testing.assert_array_equal(got, expect)
    # extract arbitrary ranges, including wrap
    for start, length in [(0, 10), (100, 33), (795, 10)]:
        got = fm.extract(start, length)
        expect = np.take(text, (start + np.arange(length)) % len(text))
        np.testing.assert_array_equal(got, expect)


def test_fm_dnarank_backend(tmp_path):
    # pac (4-symbol, no terminator) BWT with DNARank backend
    from bwtb3m.engine import BwtOptions, compute_bwt
    from bwtb3m.io.pac import write_pac
    codes = random_string(600, 4, seed=9)
    pacp = str(tmp_path / "x.pac")
    write_pac(pacp, codes)
    res = compute_bwt(BwtOptions(input_path=pacp, input_type="pac",
                                 sa_sampling_rate=8, isa_sampling_rate=8,
                                 preisa_sampling_rate=128, verbose=0))
    fm = FMIndex.from_bwt_result(res, structure="dnarank")
    pat = codes[17:23]
    lo, hi = fm.backward_search(pat)
    naive = sum(1 for p in range(len(codes))
                if np.array_equal(np.take(codes, (p + np.arange(6)) % len(codes)), pat))
    assert hi - lo == naive


def test_sampled_sa_subsample():
    vals = np.arange(0, 100, 4)
    s = SampledSA(4, vals, 100)
    s2 = s.subsample(4)
    assert s2.rate == 16
    np.testing.assert_array_equal(s2.values, vals[::4])


def test_bwa_export(tmp_path):
    from bwtb3m.engine import BwtOptions, compute_bwt
    from bwtb3m.io.pac import write_pac
    rng = np.random.default_rng(12)
    codes = rng.integers(0, 4, size=777, dtype=np.int32)
    pacp = str(tmp_path / "g.pac")
    write_pac(pacp, codes)
    res = compute_bwt(BwtOptions(input_path=pacp, input_type="pacterm",
                                 sa_sampling_rate=32, isa_sampling_rate=32,
                                 preisa_sampling_rate=128, verbose=0))
    out_bwt = str(tmp_path / "g.bwt.bwa")
    out_sa = str(tmp_path / "g.sa.bwa")
    rewrite(res.bwt_path, out_bwt, out_sa, verbose=0)

    primary, L2, bases = read_bwa_bwt(out_bwt)
    # independent ground truth: circular BWT of shifted text + terminator
    text = np.concatenate([codes + 1, [0]]).astype(np.int32)
    full_bwt = naive_bwt(text)
    prim_ref = int(np.flatnonzero(full_bwt == 0)[0])
    assert primary == prim_ref
    np.testing.assert_array_equal(bases, np.delete(full_bwt, prim_ref) - 1)
    np.testing.assert_array_equal(
        L2, np.cumsum(np.bincount(bases, minlength=4)))

    p2, L2b, sa_intv, seq_len, vals = read_bwa_sa(out_sa)
    assert p2 == primary and seq_len == len(codes) and sa_intv == 32
    sa = naive_circular_sa(text)
    np.testing.assert_array_equal(vals, sa[::32][1:])


def test_wavelet_sparse_large_symbols(tmp_path):
    # unicode-codepoint-like sparse alphabets (utf-8 input type)
    rng = np.random.default_rng(31)
    alphabet = np.array([97, 233, 956, 8364, 28450], dtype=np.int64)  # a é μ € 漢
    syms = alphabet[rng.integers(0, len(alphabet), 1500)]
    wt = HuffmanWaveletTree.build(syms)
    np.testing.assert_array_equal(wt.decode_all(), syms)
    for c in alphabet:
        qs = np.array([0, 100, 1500])
        ref = np.array([np.count_nonzero(syms[:q] == c) for q in qs])
        np.testing.assert_array_equal(wt.rank(int(c), qs), ref)
    path = str(tmp_path / "u.hwt")
    wt.write(path)
    wt2 = HuffmanWaveletTree.read(path)
    np.testing.assert_array_equal(wt2.decode_all(), syms)


def test_fm_backward_search_wide_alphabet(tmp_path):
    # engine + FM search over a utf-8 text
    from bwtb3m.engine import BwtOptions, compute_bwt
    text = ("αβγδ εζηθ ικλμ " * 40) + "νξοπ"
    p = tmp_path / "g.txt"
    p.write_text(text, encoding="utf-8")
    res = compute_bwt(BwtOptions(input_path=str(p), input_type="utf-8",
                                 sa_sampling_rate=8, isa_sampling_rate=8,
                                 preisa_sampling_rate=64, verbose=0))
    fm = FMIndex.from_bwt_result(res, structure="hwt")
    codes = np.array([ord(c) for c in text], dtype=np.int64)
    pat = codes[5:12]
    lo, hi = fm.backward_search(pat)
    naive = sum(1 for i in range(len(codes))
                if np.array_equal(np.take(codes, (i + np.arange(7)) % len(codes)), pat))
    assert hi - lo == naive
    np.testing.assert_array_equal(np.sort(fm.locate_batch(np.arange(lo, hi)) % len(codes)),
                                  np.sort([i for i in range(len(codes))
                                           if np.array_equal(np.take(codes, (i + np.arange(7)) % len(codes)), pat)]))

"""Scaled blockwise engine (BWT+samples regions, device chains) vs the
doubling engine — bit-identical BWT, preisa samples, r_start."""

import numpy as np
import pytest

from bwtb3m.engine.options import BwtOptions
from bwtb3m.engine.merge_scaled import blockwise_bwt_scaled
from bwtb3m.ops.doubling import suffix_array
from bwtb3m.util.log import VerboseLog


def _opts(n, nb, tmp_path):
    return BwtOptions(input_path="x",
                      output_filename=str(tmp_path / "t.bwt"),
                      max_block_symbols=-(-n // nb))


@pytest.mark.parametrize("n,nb,rate", [
    (4096, 4, 256),   # 256-aligned blocks (regression: rank at i == |M|)
    (5000, 3, 256),   # ragged tail block
    (3000, 7, 128),   # many levels + carried odd region
    (2048, 2, 32),    # single merge, dense sampling
])
def test_scaled_matches_doubling_random(n, nb, rate, tmp_path):
    rng = np.random.default_rng(n + nb)
    text = rng.integers(0, 4, n).astype(np.int32)
    bwt_s, spos, srank, hist = blockwise_bwt_scaled(
        text, 4, _opts(n, nb, tmp_path), VerboseLog(0),
        sample_rate=rate, lane_bucket=64)
    sa, isa, bwt_d = suffix_array(text, 4)
    assert np.array_equal(bwt_s.astype(np.int64), np.asarray(bwt_d, np.int64))
    assert np.array_equal(spos, np.arange(0, n, rate))
    assert np.array_equal(srank, np.asarray(isa)[spos])
    assert np.array_equal(hist, np.bincount(text, minlength=4))


def test_scaled_repetitive_text(tmp_path):
    rng = np.random.default_rng(5)
    seg = rng.integers(0, 4, 97)
    n = 4000
    text = np.tile(seg, n // 97 + 1)[:n].astype(np.int32)
    idx = rng.integers(0, n, 40)
    text[idx] = rng.integers(0, 4, len(idx))
    bwt_s, spos, srank, _ = blockwise_bwt_scaled(
        text, 4, _opts(n, 5, tmp_path), VerboseLog(0),
        sample_rate=512, lane_bucket=32)
    sa, isa, bwt_d = suffix_array(text, 4)
    assert np.array_equal(bwt_s.astype(np.int64), np.asarray(bwt_d, np.int64))
    assert np.array_equal(srank, np.asarray(isa)[spos])


def test_scaled_pacterm_like(tmp_path):
    # sigma=5 with unique smallest terminator (the BWA pipeline shape)
    rng = np.random.default_rng(9)
    n = 3333
    text = rng.integers(1, 5, n).astype(np.int32)
    text[-1] = 0
    bwt_s, spos, srank, _ = blockwise_bwt_scaled(
        text, 5, _opts(n, 4, tmp_path), VerboseLog(0),
        sample_rate=256, lane_bucket=64)
    sa, isa, bwt_d = suffix_array(text, 5)
    assert np.array_equal(bwt_s.astype(np.int64), np.asarray(bwt_d, np.int64))
    assert np.array_equal(srank, np.asarray(isa)[spos])


@pytest.mark.slow
def test_scaled_via_compute_bwt_engine_merge(tmp_path):
    # end-to-end through the api: engine="merge" now routes to the scaled
    # implementation; checkbwt + bwtcomputessa must accept its outputs
    from bwtb3m.engine import check_bwt, compute_bwt, compute_ssa
    rng = np.random.default_rng(11)
    n = 6000
    raw = rng.choice(np.frombuffer(b"ACGT", np.uint8), size=n)
    p = tmp_path / "t.bin"
    p.write_bytes(raw.tobytes())
    res = compute_bwt(BwtOptions(
        input_path=str(p), engine="merge", max_block_symbols=2048,
        preisa_sampling_rate=512, bwt_only=True))
    text = raw.astype(np.int32)
    assert check_bwt(res, text)
    sa_path, isa_path = compute_ssa(res.bwt_path, 32, 64)
    from bwtb3m.io import formats
    _r, sa_vals = formats.read_sampled_array(sa_path)
    sa, isa, _ = suffix_array(text, int(text.max()) + 1)
    assert np.array_equal(sa_vals, np.asarray(sa)[::32])


def test_scaled_adversarial_periodic(tmp_path):
    # pure periodic blocks (period 16, no in-block mutation): every block
    # sort resolves via the rotation-comparator tie-break without growing
    # the window (the round-1 memory-bound escape)
    rng = np.random.default_rng(77)
    seg = rng.integers(0, 4, 16)
    n = 8192
    text = np.tile(seg, n // 16).astype(np.int32)
    # two mutations far apart so rotations are distinct but in-block ties
    # span whole blocks
    text[10] = (text[10] + 1) % 4
    text[7000] = (text[7000] + 2) % 4
    opts = BwtOptions(input_path="x", output_filename=str(tmp_path / "p.bwt"),
                      max_block_symbols=2048, large_lcp_thres=1024)
    bwt_s, spos, srank, _ = blockwise_bwt_scaled(
        text, 4, opts, VerboseLog(0), sample_rate=512, lane_bucket=32)
    sa, isa, bwt_d = suffix_array(text, 4)
    assert np.array_equal(bwt_s.astype(np.int64), np.asarray(bwt_d, np.int64))
    assert np.array_equal(srank, np.asarray(isa)[spos])


def test_scaled_fully_periodic_equal_rotations(tmp_path):
    # period divides n exactly: genuinely equal rotations (position order)
    seg = np.array([1, 0, 2, 3, 2, 1, 0, 3], np.int32)
    n = 4096
    text = np.tile(seg, n // 8).astype(np.int32)
    opts = BwtOptions(input_path="x", output_filename=str(tmp_path / "q.bwt"),
                      max_block_symbols=1024, large_lcp_thres=512)
    bwt_s, spos, srank, _ = blockwise_bwt_scaled(
        text, 4, opts, VerboseLog(0), sample_rate=512, lane_bucket=16)
    sa, isa, bwt_d = suffix_array(text, 4)
    assert np.array_equal(bwt_s.astype(np.int64), np.asarray(bwt_d, np.int64))
    assert np.array_equal(srank, np.asarray(isa)[spos])


def test_scaled_bytestream_sigma256(tmp_path):
    # full byte alphabet incl. symbols >= 128 (int8 sign-extension traps):
    # the scaled engine must match the doubling engine bit-for-bit
    rng = np.random.default_rng(21)
    n = 5000
    text = rng.integers(0, 256, n).astype(np.int32)
    text[:16] = np.arange(240, 256)  # force high bytes near the start
    bwt_s, spos, srank, hist = blockwise_bwt_scaled(
        text, 256, _opts(n, 4, tmp_path), VerboseLog(0),
        sample_rate=512, lane_bucket=64)
    sa, isa, bwt_d = suffix_array(text, 256)
    assert np.array_equal(bwt_s.astype(np.int64), np.asarray(bwt_d, np.int64))
    assert np.array_equal(srank, np.asarray(isa)[spos])
    assert np.array_equal(hist, np.bincount(text, minlength=256))


@pytest.mark.slow
def test_scaled_bytestream_end_to_end(tmp_path):
    # bytestream through the api: scaled engine + fused checkbwt + ssa at
    # sigma 256 (round-3: memory-bounded construction for wide alphabets)
    from bwtb3m.engine import check_bwt, compute_bwt, compute_ssa
    rng = np.random.default_rng(23)
    n = 6000
    raw = rng.integers(0, 256, n, dtype=np.uint8)
    raw[100:120] = 200 + np.arange(20)
    p = tmp_path / "b.bin"
    p.write_bytes(raw.tobytes())
    res = compute_bwt(BwtOptions(
        input_path=str(p), engine="merge", max_block_symbols=2048,
        preisa_sampling_rate=512, bwt_only=True))
    text = raw.astype(np.int32)
    assert check_bwt(res, text)
    sa_path, _ = compute_ssa(res.bwt_path, 32, 64)
    from bwtb3m.io import formats
    _r, sa_vals = formats.read_sampled_array(sa_path)
    sa, _isa, _ = suffix_array(text, 256)
    assert np.array_equal(sa_vals, np.asarray(sa)[::32])


def test_scaled_wide_alphabet_rank_compacted(tmp_path):
    # utf-8-style wide codepoints: api rank-compacts to dense bytes, runs
    # the scaled engine, and maps the BWT back to original symbols
    from bwtb3m.engine import check_bwt, compute_bwt
    rng = np.random.default_rng(29)
    n = 4000
    alphabet = np.array([65, 955, 0x4E2D, 0x1F600, 97, 10], np.int32)
    text = alphabet[rng.integers(0, len(alphabet), n)]
    import codecs
    p = tmp_path / "u.txt"
    p.write_bytes("".join(chr(c) for c in text).encode("utf-8"))
    res = compute_bwt(BwtOptions(
        input_path=str(p), input_type="utf-8", engine="merge",
        max_block_symbols=1024, preisa_sampling_rate=512, bwt_only=True))
    assert check_bwt(res, text)
    sa, _isa, bwt_d = suffix_array(text, int(text.max()) + 1)
    from bwtb3m.io.rl import open_bwt
    with open_bwt(res.bwt_path) as r:
        bwt_file = r.decode_all()
    assert np.array_equal(np.asarray(bwt_file, np.int64),
                          np.asarray(bwt_d, np.int64))


@pytest.mark.slow
def test_scaled_periodic_scale_memory_bound(tmp_path):
    # prove the block-sort memory bound holds on a
    # LARGE periodic text (n ~ 10^6, period << n). The _resolve_tie_groups
    # escape hatch (mixed tie runs > 4096 -> grow the window toward n)
    # must never fire; every tie component resolves via the rotation
    # comparator at the bounded lookahead.
    from bwtb3m.engine import merge_scaled as ms

    rng = np.random.default_rng(11)
    seg = rng.integers(0, 4, 64)
    n = 1_000_000
    text = np.tile(seg, n // 64 + 1)[:n].astype(np.int32)
    # sparse mutations: rotations distinct, but in-block prefix ties span
    # entire blocks between mutation sites
    mut = rng.integers(0, n, 12)
    text[mut] = (text[mut] + 1 + rng.integers(0, 3, 12)) % 4

    escapes = []
    orig = ms._resolve_tie_groups

    def probe(ctx, s, e, lo, hi):
        out = orig(ctx, s, e, lo, hi)
        if out is None:
            escapes.append((s, e))
        return out

    ms._resolve_tie_groups = probe
    try:
        opts = BwtOptions(input_path="x",
                          output_filename=str(tmp_path / "big.bwt"),
                          max_block_symbols=250_000, large_lcp_thres=4096)
        bwt_s, spos, srank, _ = blockwise_bwt_scaled(
            text, 4, opts, VerboseLog(0), sample_rate=65536,
            lane_bucket=4096)
    finally:
        ms._resolve_tie_groups = orig
    assert escapes == [], "memory-bound escape hatch fired: %r" % escapes
    sa, isa, bwt_d = suffix_array(text, 4)
    assert np.array_equal(bwt_s.astype(np.int64), np.asarray(bwt_d, np.int64))
    assert np.array_equal(srank, np.asarray(isa)[spos])


def test_gap_u16_wrap_fallback(tmp_path):
    # > 2^16 left suffixes between ONE adjacent right-rotation pair: text
    # a^(n-1) b with the left block all a's. Every left rotation (a-prefix
    # >= right block length) falls in the same gap cell, wrapping the u16
    # histogram; the checksum mismatch must trigger the int32 rerun and
    # the result must stay bit-identical to the doubling engine.
    n = 65792 + 250
    text = np.zeros(n, np.int32)
    text[-1] = 1
    opts = BwtOptions(input_path="x",
                      output_filename=str(tmp_path / "t.bwt"),
                      max_block_symbols=65792)

    msgs = []
    log = VerboseLog(0)
    log.v = lambda *a: msgs.append(a[0] if a else "")
    bwt_s, spos, srank, _hist = blockwise_bwt_scaled(
        text, 2, opts, log, sample_rate=8192, lane_bucket=64)
    assert any("rerunning chains with" in m for m in msgs), msgs
    sa, isa, bwt_d = suffix_array(text, 2)
    assert np.array_equal(bwt_s.astype(np.int64), np.asarray(bwt_d, np.int64))
    assert np.array_equal(srank, np.asarray(isa)[spos])

"""Batched same-level merges (ops/gapbatch.py): bit-identity against the
doubling engine and against the per-pair scaled path, plus the fallback
paths (u16 wrap, HBM gate)."""

import numpy as np
import pytest

from bwtb3m.engine.options import BwtOptions
from bwtb3m.engine.merge_scaled import blockwise_bwt_scaled
from bwtb3m.ops.doubling import suffix_array
from bwtb3m.util.log import VerboseLog


def _opts(n, nb, tmp_path, **kw):
    return BwtOptions(input_path="x",
                      output_filename=str(tmp_path / "t.bwt"),
                      max_block_symbols=-(-n // nb), **kw)


def _log_probe(msgs):
    log = VerboseLog(0)
    log.v = lambda *a: msgs.append(a[0] if a else "")
    return log


@pytest.mark.parametrize("n,nb,rate", [
    (4096, 4, 256),    # one level of 2 pair merges + root
    (6000, 6, 256),    # 3 pairs, ragged tail block
    (9000, 9, 128),    # odd region carried through a batched level
    (4096, 8, 64),     # two batched levels before the root
])
def test_batched_matches_doubling_random(n, nb, rate, tmp_path):
    rng = np.random.default_rng(n * 31 + nb)
    text = rng.integers(0, 4, n).astype(np.int32)
    msgs = []
    bwt_b, spos, srank, hist = blockwise_bwt_scaled(
        text, 4, _opts(n, nb, tmp_path), _log_probe(msgs),
        sample_rate=rate, lane_bucket=256)
    assert any("batched level" in m for m in msgs), msgs
    sa, isa, bwt_d = suffix_array(text, 4)
    assert np.array_equal(bwt_b.astype(np.int64), np.asarray(bwt_d, np.int64))
    assert np.array_equal(srank, np.asarray(isa)[spos])
    assert np.array_equal(hist, np.bincount(text, minlength=4))


def test_batched_matches_per_pair(tmp_path):
    # the batched level must produce the same regions (BWT + samples +
    # r_start) as the per-pair path it replaces
    rng = np.random.default_rng(99)
    n = 5000
    text = rng.integers(0, 4, n).astype(np.int32)
    out_b = blockwise_bwt_scaled(
        text, 4, _opts(n, 5, tmp_path), VerboseLog(0),
        sample_rate=128, lane_bucket=128)
    out_p = blockwise_bwt_scaled(
        text, 4, _opts(n, 5, tmp_path, batch_merges=False), VerboseLog(0),
        sample_rate=128, lane_bucket=128)
    for a, b in zip(out_b, out_p):
        assert np.array_equal(a, b)


def test_batched_bytestream_sigma256(tmp_path):
    # byte-row FusedOcc concatenation (sigma > 8 path)
    rng = np.random.default_rng(7)
    n = 4096
    text = rng.integers(0, 256, n).astype(np.int32)
    msgs = []
    bwt_b, spos, srank, _ = blockwise_bwt_scaled(
        text, 256, _opts(n, 4, tmp_path), _log_probe(msgs),
        sample_rate=512, lane_bucket=128)
    assert any("batched level" in m for m in msgs), msgs
    sa, isa, bwt_d = suffix_array(text, 256)
    assert np.array_equal(bwt_b.astype(np.int64), np.asarray(bwt_d, np.int64))
    assert np.array_equal(srank, np.asarray(isa)[spos])


@pytest.mark.slow
def test_batched_u16_wrap_falls_back_per_pair(tmp_path):
    # a^(n-1) b across 4 blocks: >= 2^16 left suffixes land between one
    # right-rotation pair in the first-level merges, wrapping the u16
    # histogram — the batched level must detect it per merge (checksum)
    # and redo those pairs through the per-pair int32 rerun, with the
    # result still bit-identical to the doubling engine
    n = 4 * 66000
    text = np.zeros(n, np.int32)
    text[-1] = 1
    msgs = []
    bwt_b, spos, srank, _ = blockwise_bwt_scaled(
        text, 2, _opts(n, 4, tmp_path), _log_probe(msgs),
        sample_rate=8192, lane_bucket=64)
    assert any("checksum mismatch: per-pair" in m for m in msgs), msgs
    sa, isa, bwt_d = suffix_array(text, 2)
    assert np.array_equal(bwt_b.astype(np.int64), np.asarray(bwt_d, np.int64))
    assert np.array_equal(srank, np.asarray(isa)[spos])


def test_batched_hbm_gate_falls_back(tmp_path, monkeypatch):
    # with a zero budget the gate must route every level per-pair
    monkeypatch.setenv("BWTB3M_BATCH_HBM", "0")
    rng = np.random.default_rng(3)
    n = 4096
    text = rng.integers(0, 4, n).astype(np.int32)
    msgs = []
    bwt_b, _, _, _ = blockwise_bwt_scaled(
        text, 4, _opts(n, 4, tmp_path), _log_probe(msgs),
        sample_rate=256, lane_bucket=64)
    assert not any("batched level" in m for m in msgs), msgs
    sa, isa, bwt_d = suffix_array(text, 4)
    assert np.array_equal(bwt_b.astype(np.int64), np.asarray(bwt_d, np.int64))


def test_batched_periodic_ties(tmp_path):
    # periodic text across a batched level (rotation-comparator gt bits
    # and wrap terms active in several merges at once)
    seg = np.array([0, 1, 2, 3, 1, 0, 2, 2], np.int32)
    n = 8192
    text = np.tile(seg, n // 8)
    text[4097] = 3
    text[70] = 1
    msgs = []
    bwt_b, spos, srank, _ = blockwise_bwt_scaled(
        text, 4, _opts(n, 4, tmp_path), _log_probe(msgs),
        sample_rate=1024, lane_bucket=64)
    assert any("batched level" in m for m in msgs), msgs
    sa, isa, bwt_d = suffix_array(text, 4)
    assert np.array_equal(bwt_b.astype(np.int64), np.asarray(bwt_d, np.int64))
    assert np.array_equal(srank, np.asarray(isa)[spos])

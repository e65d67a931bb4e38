"""Device-resident interleave (ops/devzip.py) vs the numpy oracle.

The oracle is the gap-guided zip definition itself (the reference's
merge of two BWT streams, SURVEY.md section 3.1 phase 3): for r = 0..B
emit gap[r] left symbols then right[r]."""

import numpy as np
import pytest

import jax.numpy as jnp

from bwtb3m.ops.devzip import (cnt_le_at_ranks, count_right_before,
                                   device_interleave, gap_row_cum_excl,
                                   rows_from_host_bwt, rows_to_host_bwt,
                                   _bits_for)


def _oracle(gap, left, right):
    cnt_le = np.cumsum(gap.astype(np.int64))
    out = np.empty(len(left) + len(right), np.uint8)
    M = len(right)
    out[np.arange(M) + cnt_le[:M]] = right
    out[np.repeat(np.arange(M + 1), gap) + np.arange(len(left))] = left
    return out


def _gap_device(gap, dtype=np.uint16):
    from bwtb3m.ops.gapdev import _pad_pow2
    grows = _pad_pow2((len(gap) + 255) // 256, lo=4)
    g = np.zeros((grows, 256), dtype)
    g.reshape(-1)[: len(gap)] = gap.astype(dtype)
    return jnp.asarray(g)


def _random_case(rng, A, B, sigma):
    left = rng.integers(0, sigma, A).astype(np.uint8)
    right = rng.integers(0, sigma, B).astype(np.uint8)
    # random composition of A into B+1 cells, with some heavy cells
    cuts = np.sort(rng.integers(0, A + 1, B))
    gap = np.diff(np.concatenate([[0], cuts, [A]])).astype(np.int64)
    return left, right, gap


@pytest.mark.parametrize("sigma", [4, 200])
@pytest.mark.parametrize("A,B", [(700, 900), (4096, 4096), (1, 5),
                                 (5000, 3), (300, 0)])
def test_device_interleave_matches_oracle(sigma, A, B):
    rng = np.random.default_rng(A * 7 + B + sigma)
    left, right, gap = _random_case(rng, A, B, sigma)
    want = _oracle(gap, left, right)
    bits = _bits_for(sigma)
    gd = _gap_device(gap)
    rc = gap_row_cum_excl(gd)
    lr = rows_from_host_bwt(left, sigma)
    rr = rows_from_host_bwt(right, sigma)
    out = device_interleave(lr, A, rr, B, gd, rc, bits)
    got = rows_to_host_bwt(out, A + B, bits)
    assert np.array_equal(got, want)


def test_device_interleave_int32_gap_heavy_cells():
    """int32 histogram (the u16-wrap rerun dtype) with cells > 2^16."""
    rng = np.random.default_rng(3)
    A, B, sigma = 1 << 18, 300, 4
    left = rng.integers(0, sigma, A).astype(np.uint8)
    right = rng.integers(0, sigma, B).astype(np.uint8)
    gap = np.zeros(B + 1, np.int64)
    gap[7] = 1 << 17          # wraps a u16 cell twice
    gap[B] = A - (1 << 17)
    want = _oracle(gap, left, right)
    gd = _gap_device(gap, np.int32)
    rc = gap_row_cum_excl(gd)
    lr = rows_from_host_bwt(left, sigma)
    rr = rows_from_host_bwt(right, sigma)
    out = device_interleave(lr, A, rr, B, gd, rc, 4)
    got = rows_to_host_bwt(out, A + B, 4)
    assert np.array_equal(got, want)


def test_count_right_before_and_cnt_le():
    rng = np.random.default_rng(11)
    A, B = 100000, 70000
    cuts = np.sort(rng.integers(0, A + 1, B))
    gap = np.diff(np.concatenate([[0], cuts, [A]])).astype(np.int64)
    cnt_le = np.cumsum(gap)
    p = np.arange(B) + cnt_le[:B]
    gd = _gap_device(gap)
    rc = gap_row_cum_excl(gd)
    ts = rng.integers(0, A + B + 1, 50).astype(np.int64)
    want = np.searchsorted(p, ts, side="left")
    got = count_right_before(gd, rc, B, ts)
    assert np.array_equal(got, want)
    ranks = rng.integers(0, B + 1, 37).astype(np.int64)
    assert np.array_equal(cnt_le_at_ranks(gd, rc, ranks), cnt_le[ranks])


@pytest.mark.parametrize("sigma,n,nb", [(4, 5000, 4), (200, 4100, 3),
                                        (5, 3000, 7)])
def test_engine_device_tree_matches_host_tree(sigma, n, nb, monkeypatch,
                                              tmp_path):
    """blockwise_bwt_scaled with the device-resident tree is bit-identical
    to the host-zip path (BWT, samples, r_start carried through hist)."""
    from bwtb3m.engine.merge_scaled import blockwise_bwt_scaled
    from bwtb3m.engine.options import BwtOptions
    from bwtb3m.util.log import VerboseLog

    rng = np.random.default_rng(sigma + n)
    text = rng.integers(0, sigma, n).astype(np.int32)
    opts = BwtOptions(input_path="x",
                      output_filename=str(tmp_path / "t.bwt"),
                      max_block_symbols=-(-n // nb))
    monkeypatch.setenv("BWTB3M_DEVICE_TREE", "0")
    host = blockwise_bwt_scaled(text, sigma, opts, VerboseLog(0),
                                sample_rate=256, lane_bucket=64)
    monkeypatch.setenv("BWTB3M_DEVICE_TREE", "1")
    dev = blockwise_bwt_scaled(text, sigma, opts, VerboseLog(0),
                               sample_rate=256, lane_bucket=64)
    for h, d in zip(host, dev):
        assert np.array_equal(h, d)


def test_engine_device_tree_u16_rerun(monkeypatch, tmp_path):
    """Periodic text wraps no u16 cell at this size; stub the checksum to
    force the per-pair int32 rerun inside the device tree and pin the
    result against the host tree."""
    from bwtb3m.engine.merge_scaled import blockwise_bwt_scaled
    from bwtb3m.engine.options import BwtOptions
    from bwtb3m.ops.gapdev import DeviceGapRunner
    from bwtb3m.util.log import VerboseLog

    rng = np.random.default_rng(2)
    base = rng.integers(0, 4, 64).astype(np.int32)
    text = np.tile(base, 64)
    opts = BwtOptions(input_path="x",
                      output_filename=str(tmp_path / "t.bwt"),
                      max_block_symbols=2048)
    monkeypatch.setenv("BWTB3M_DEVICE_TREE", "0")
    host = blockwise_bwt_scaled(text, 4, opts, VerboseLog(0),
                                sample_rate=128, lane_bucket=32)
    monkeypatch.setenv("BWTB3M_DEVICE_TREE", "1")
    # the device-tree per-pair path reads its checksum from the fused
    # zip_plan (ONE dispatch+fetch); corrupt the first plan's total to
    # force the int32 rerun
    from bwtb3m.ops import devzip as dz
    real_plan = dz.zip_plan
    calls = {"n": 0}

    def fake_plan(*a, **kw):
        total, r_starts, cnt = real_plan(*a, **kw)
        calls["n"] += 1
        if calls["n"] == 1:
            return total - 1, r_starts, cnt
        return total, r_starts, cnt

    monkeypatch.setattr(dz, "zip_plan", fake_plan)
    dev = blockwise_bwt_scaled(text, 4, opts, VerboseLog(0),
                               sample_rate=128, lane_bucket=32)
    assert calls["n"] >= 2
    for h, d in zip(host, dev):
        assert np.array_equal(h, d)


def test_level_global_offsets():
    """row0/cum_base address one merge's span of a level-global gap (the
    batched path): results must equal the per-pair layout."""
    rng = np.random.default_rng(5)
    A, B, sigma = 3000, 2600, 4
    left, right, gap = _random_case(rng, A, B, sigma)
    want = _oracle(gap, left, right)
    # embed at row base 8 of a bigger histogram with junk before/after
    from bwtb3m.ops.gapdev import _pad_pow2
    row0 = 8
    cells0 = row0 * 256
    total = cells0 + (B + 1)
    grows = _pad_pow2((total + 255) // 256 + 4, lo=4)
    g = np.zeros((grows, 256), np.uint16)
    g.reshape(-1)[:cells0] = rng.integers(0, 9, cells0)
    g.reshape(-1)[cells0 : cells0 + B + 1] = gap.astype(np.uint16)
    g.reshape(-1)[cells0 + B + 1 + 256 :] = 3   # junk past the gutter
    gd = jnp.asarray(g)
    rc = gap_row_cum_excl(gd)
    cum_base = rc[row0]
    lr = rows_from_host_bwt(left, sigma)
    rr = rows_from_host_bwt(right, sigma)
    out = device_interleave(lr, A, rr, B, gd, rc, 4, row0=row0,
                            cum_base=cum_base)
    got = rows_to_host_bwt(out, A + B, 4)
    assert np.array_equal(got, want)
    cnt_le = np.cumsum(gap)
    ranks = rng.integers(0, B + 1, 23).astype(np.int64)
    assert np.array_equal(
        cnt_le_at_ranks(gd, rc, ranks, row0=row0, cum_base=cum_base),
        cnt_le[ranks])


def test_wide_pair_helpers_exact_past_2_32():
    """(hi, lo) wide helpers (gap_row_cum_excl_w / cnt_le_at_ranks_w /
    count_right_before_w / gap_checksum_w) stay exact when cumulative
    sums exceed 2^32 — synthetic histogram with 2^30-scale cells, int64
    numpy reference."""
    from bwtb3m.ops.devzip import (cnt_le_at_ranks_w,
                                       count_right_before_w,
                                       gap_checksum_w, gap_row_cum_excl_w)
    rng = np.random.default_rng(9)
    rows = 8
    gap = rng.integers(0, 1 << 30, (rows, 256)).astype(np.int32)
    flat = gap.astype(np.int64).reshape(-1)
    cum_incl = np.cumsum(flat)                     # ~2^41 total
    gj = jnp.asarray(gap)
    ch, cl = gap_row_cum_excl_w(gj)
    row_sums = flat.reshape(rows, 256).sum(1)
    excl = np.cumsum(row_sums) - row_sums
    got = (np.asarray(ch, np.int64) << 32) | np.asarray(cl, np.int64)
    np.testing.assert_array_equal(got, excl)
    assert gap_checksum_w(gj) == int(flat.sum())
    ranks = rng.integers(0, rows * 256, 50).astype(np.int64)
    np.testing.assert_array_equal(
        cnt_le_at_ranks_w(gj, (ch, cl), ranks), cum_incl[ranks])
    B = rows * 256 - 2
    F = np.arange(B, dtype=np.int64) + cum_incl[:B]
    ts = np.sort(rng.integers(0, int(F[-1]) + 10, 40))
    want = np.searchsorted(F, ts, side="left")     # #r with F(r) < t
    np.testing.assert_array_equal(
        count_right_before_w(gj, (ch, cl), B, ts), want)


def test_wide_device_interleave_matches_host_route(monkeypatch):
    """Forced-wide build through the DEVICE tree (build_focc_from_rows ->
    wide chains -> _finish_merge_dev_wide) is bit-identical to the same
    build with the device tree disabled (host zip/fetch route)."""
    from bwtb3m.engine.merge_scaled import blockwise_bwt_scaled
    from bwtb3m.engine.options import BwtOptions
    from bwtb3m.util.log import VerboseLog

    rng = np.random.default_rng(77)
    n = 6000
    text = rng.integers(0, 4, n).astype(np.int32)
    opts = BwtOptions(input_path="x", output_filename="/tmp/wdt.bwt",
                      max_block_symbols=2048, batch_merges=False)
    monkeypatch.setenv("BWTB3M_FORCE_WIDE", "1")
    dev = blockwise_bwt_scaled(text, 4, opts, VerboseLog(0),
                               sample_rate=512, lane_bucket=32)
    monkeypatch.setenv("BWTB3M_DEVICE_TREE", "0")
    host = blockwise_bwt_scaled(text, 4, opts, VerboseLog(0),
                                sample_rate=512, lane_bucket=32)
    for d, h in zip(dev, host):
        assert np.array_equal(d, h)


@pytest.mark.slow
def test_interleave_multi_chunk_large_total():
    """total > one zip chunk (the 2^26 tier): the output buffer must be
    CHUNK-ALIGNED — dynamic_update_slice CLAMPS an out-of-range start
    and silently relocates the write (corruption from symbol 2^24 at a
    400M build)."""
    from bwtb3m.ops.devzip import (_chunk_size, gap_row_cum_excl)
    from bwtb3m.ops.gapdev import _pad_pow2
    rng = np.random.default_rng(0)
    A, B = 35_000_000, 34_000_000
    assert A + B > _chunk_size(A + B)          # really multi-chunk
    gap = rng.multinomial(A, np.ones(B + 1) / (B + 1)).astype(np.uint16)
    left = rng.integers(0, 4, A, dtype=np.uint8)
    right = rng.integers(0, 4, B, dtype=np.uint8)
    cnt_le = np.cumsum(gap.astype(np.int64))
    out_ref = np.empty(A + B, np.uint8)
    out_ref[np.arange(B) + cnt_le[:B]] = right
    out_ref[np.repeat(np.arange(B + 1), gap) + np.arange(A)] = left
    grows = _pad_pow2((B + 1 + 255) // 256, lo=4)
    g = np.zeros((grows, 256), np.uint16)
    g.reshape(-1)[: B + 1] = gap
    gd = jnp.asarray(g)
    rc = gap_row_cum_excl(gd)
    got = rows_to_host_bwt(device_interleave(
        rows_from_host_bwt(left, 4), A, rows_from_host_bwt(right, 4), B,
        gd, rc, 4), A + B, 4)
    assert int((got != out_ref).sum()) == 0

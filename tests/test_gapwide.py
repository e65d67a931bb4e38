"""Two-word gap chains (ops/gapwide.py) — the merge path for texts whose
per-merge rank spaces exceed uint32 (n >= 2^33).

A real 8.6 G-symbol build cannot run here, so the wide runner is pinned
three ways:

1. carry discipline of ``_chain_step_w`` against plain int64 ground
   truth with doctored rank replies straddling 2^32 (add-carry, the
   wrap +1 carry out of 0xFFFFFFFF, the corr borrow through zero);
2. bit-identity of one forced-wide pair merge against the narrow
   DeviceGapRunner on the same regions (anchors, chains, gap histogram,
   sample harvest, zip — hi words all zero);
3. a forced-wide multi-block end-to-end build against the narrow build
   and the doubling oracle.
"""

import numpy as np
import pytest

jnp = pytest.importorskip("jax.numpy")

from bwtb3m.engine.merge_scaled import (_Ctx, _merge_pair_scaled,
                                            _sort_block_scaled,
                                            blockwise_bwt_scaled)
from bwtb3m.engine.options import BwtOptions
from bwtb3m.ops import gapwide
from bwtb3m.util.log import VerboseLog

TWO32 = 1 << 32


def _split64(v):
    a = np.asarray(v, np.uint64)
    return ((a >> np.uint64(32)).astype(np.uint32),
            (a & np.uint64(0xFFFFFFFF)).astype(np.uint32))


def test_chain_step_w_carry_discipline(monkeypatch):
    """r_new = c_first[c] + rank(c, r) - corr + wrap in two uint32 words,
    vs the same recurrence in int64.  rank replies are doctored to force
    every carry/borrow edge: lo-word add wrap, the wrap-term increment
    carrying out of 0xFFFFFFFF, and the corr borrow through a zero lo."""
    rng = np.random.default_rng(41)
    B = 512
    sigma = 6
    cf64 = np.sort(rng.integers(0, 1 << 36, sigma)).astype(np.uint64)
    cf64[0] = 0
    isa_m = int(rng.integers(0, 1 << 35))
    sym_m, sym_last = 2, 4

    rk64 = rng.integers(0, 1 << 36, B).astype(np.uint64)
    c = rng.integers(0, sigma, B).astype(np.int32)
    g0 = rng.integers(0, 2, B).astype(np.int32)
    r64 = rng.integers(0, 1 << 36, B).astype(np.uint64)
    # [0:64): cnt_lo + rk_lo wraps to exactly 0 while corr fires — the
    # add carry (c1) and then the borrow (b3) through lo == 0
    c[:64] = sym_m
    g0[:64] = 0
    r64[:64] = np.uint64(isa_m) + 1 + np.arange(64).astype(np.uint64)
    rk64[:64] = ((np.uint64(TWO32)
                  - (cf64[sym_m] & np.uint64(TWO32 - 1))) % np.uint64(TWO32))
    # [64:128): lo1 == 0xFFFFFFFF and the wrap term fires -> c2 carry
    c[64:128] = sym_last
    g0[64:128] = 1
    rk64[64:128] = (np.uint64(TWO32 - 1)
                    - (cf64[sym_last] & np.uint64(TWO32 - 1)))
    active = np.ones(B, bool)
    active[rng.integers(0, B, 32)] = False

    # ground truth in int64
    corr = ((np.int64(isa_m) < r64.astype(np.int64))
            & (c == sym_m)).astype(np.int64)
    wrap = ((c == sym_last) & (g0 == 1)).astype(np.int64)
    want = np.where(
        active,
        cf64[c].astype(np.int64) + rk64.astype(np.int64) - corr + wrap,
        r64.astype(np.int64))

    monkeypatch.setattr(
        gapwide, "rank_batch_w",
        lambda w, cc, rh, rl: tuple(map(jnp.asarray, _split64(rk64))))
    cf_hi, cf_lo = _split64(cf64)
    ihi, ilo = _split64([isa_m])
    consts_hi = jnp.asarray(np.array([ihi[0], 0, 0], np.uint32))
    consts_lo = jnp.asarray(np.array([ilo[0], sym_m, sym_last], np.uint32))
    r_hi, r_lo = _split64(r64)
    out_hi, out_lo = gapwide._chain_step_w(
        None, jnp.asarray(cf_hi), jnp.asarray(cf_lo), consts_hi, consts_lo,
        jnp.asarray(r_hi), jnp.asarray(r_lo), jnp.asarray(c),
        jnp.asarray(g0), jnp.asarray(active))
    got = ((np.asarray(out_hi).astype(np.int64) << 32)
           | np.asarray(out_lo).astype(np.int64))
    assert np.array_equal(got, want)


def _regions(text, sigma, block, rate=64):
    opts = BwtOptions(input_path="unused", verbose=0,
                      max_block_symbols=block)
    ctx = _Ctx(text, sigma, rate, opts, VerboseLog(0), lane_bucket=256)
    bounds = list(range(0, len(text), block))
    regs = [_sort_block_scaled(ctx, s, min(s + block, len(text)))
            for s in bounds]
    return ctx, regs


def test_wide_pair_merge_matches_narrow(monkeypatch):
    rng = np.random.default_rng(7)
    text = rng.integers(0, 5, 6144).astype(np.uint8)
    ctx, regs = _regions(text, 5, 3072)
    left, right = regs
    narrow = _merge_pair_scaled(ctx, left, right)
    assert narrow.e - narrow.s == len(text)
    ctx2, regs2 = _regions(text, 5, 3072)
    monkeypatch.setenv("BWTB3M_FORCE_WIDE", "1")
    wide = _merge_pair_scaled(ctx2, regs2[0], regs2[1])
    from bwtb3m.engine.merge_scaled import _region_bwt
    assert np.array_equal(_region_bwt(ctx2, wide), _region_bwt(ctx, narrow))
    assert np.array_equal(wide.samp_pos, narrow.samp_pos)
    assert np.array_equal(wide.samp_rank, narrow.samp_rank)
    assert wide.r_start == narrow.r_start
    assert np.array_equal(wide.hist, narrow.hist)


def test_wide_pair_merge_repetitive_int32_rerun(monkeypatch):
    """Exercises the wide runner's force_int32 rerun path for real
    (at this size no u16 cell can wrap naturally, so the
    checksum is stubbed to mismatch once) and pins bit-identity of the
    rerun result against the narrow merge."""
    from bwtb3m.ops.gapwide import WideDeviceGapRunner

    rng = np.random.default_rng(11)
    base = rng.integers(0, 4, 64).astype(np.uint8)
    text = np.tile(base, 64)
    ctx, regs = _regions(text, 4, 2048, rate=32)
    narrow = _merge_pair_scaled(ctx, regs[0], regs[1])
    ctx2, regs2 = _regions(text, 4, 2048, rate=32)
    monkeypatch.setenv("BWTB3M_FORCE_WIDE", "1")
    real_checksum = WideDeviceGapRunner.gap_checksum
    real_run = WideDeviceGapRunner.run_chains
    calls = {"checksum": 0, "forced": 0}

    def fake_checksum(self):
        calls["checksum"] += 1
        if calls["checksum"] == 1:
            return real_checksum(self) - 1   # simulate a wrapped u16 cell
        return real_checksum(self)

    def spy_run(self, *a, **kw):
        if kw.get("force_int32"):
            calls["forced"] += 1
        return real_run(self, *a, **kw)

    monkeypatch.setattr(WideDeviceGapRunner, "gap_checksum", fake_checksum)
    monkeypatch.setattr(WideDeviceGapRunner, "run_chains", spy_run)
    wide = _merge_pair_scaled(ctx2, regs2[0], regs2[1])
    assert calls["forced"] == 1, "int32 rerun branch must fire"
    from bwtb3m.engine.merge_scaled import _region_bwt
    assert np.array_equal(_region_bwt(ctx2, wide), _region_bwt(ctx, narrow))
    assert np.array_equal(wide.samp_rank, narrow.samp_rank)


@pytest.mark.slow
def test_force_wide_build_end_to_end(monkeypatch):
    from bwtb3m.ops.doubling import suffix_array

    rng = np.random.default_rng(23)
    text = rng.integers(0, 6, 20000).astype(np.uint8)
    opts = BwtOptions(input_path="unused", verbose=0,
                      max_block_symbols=4096, batch_merges=False)
    bwt_n, pos_n, rank_n, hist_n = blockwise_bwt_scaled(
        text, 6, opts, VerboseLog(0), sample_rate=128)
    monkeypatch.setenv("BWTB3M_FORCE_WIDE", "1")
    bwt_w, pos_w, rank_w, hist_w = blockwise_bwt_scaled(
        text, 6, opts, VerboseLog(0), sample_rate=128)
    _sa, _isa, bwt_o = suffix_array(text.astype(np.int32), 6)
    assert np.array_equal(bwt_w, np.asarray(bwt_o).astype(np.uint8))
    assert np.array_equal(bwt_w, bwt_n)
    assert np.array_equal(pos_w, pos_n)
    assert np.array_equal(rank_w, rank_n)
    assert np.array_equal(hist_w, hist_n)


def test_scale_gate_moved_to_2_35():
    """The up-front gate moved from 2^33 to the wide runner's real bound
    (THR_K wrap tracking, ops/wideocc.py): lengths in [2^33, 2^35) pass
    validation (their big merges dispatch the wide runner), 2^35 raises."""
    from bwtb3m.engine.merge_scaled import _validate_scale
    _validate_scale((1 << 33) + 5)
    _validate_scale((1 << 35) - 1)
    with pytest.raises(ValueError, match="2\\^35"):
        _validate_scale(1 << 35)

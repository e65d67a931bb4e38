"""Rank-range-sharded occ rows (parallel/shocc.py) vs the single-device
gap runner: same anchors, same gap histogram, same samples, bit-exact.

This is the multi-chip path that lifts the per-merge right-region bound
from one device's HBM to the mesh aggregate (ROADMAP open #3; reference
analog: sparse external gap files, /root/reference/src/bwtb3m.cpp:53).
"""

import numpy as np
import pytest

from bwtb3m.ops.doubling import suffix_array
from bwtb3m.ops.focc import build_focc
from bwtb3m.ops.gapdev import DeviceGapRunner, build_text_rows, upload_bwt
from bwtb3m.parallel import make_mesh
from bwtb3m.parallel.shocc import ShardedOccGapRunner


def _setup(sigma, seed, n=1 << 13, rate=0):
    rng = np.random.default_rng(seed)
    text = rng.integers(0, sigma, n).astype(np.uint8)
    sa, isa, _ = suffix_array(text.astype(np.int32), sigma)
    sa = np.asarray(sa)
    m = n // 2
    sel = sa[(sa >= m)]
    right_bwt = text[(sel - 1) % n]
    focc = build_focc(upload_bwt(right_bwt, sigma), sigma)
    isa_m = int(np.flatnonzero(sel == m)[0])
    trows = build_text_rows(text, sigma)
    hist = np.bincount(text[m:], minlength=sigma).astype(np.int64)

    def mk():
        return DeviceGapRunner(
            focc, trows, text, 0, m, n, isa_m, hist,
            lane_bucket=64, sample_rate=rate)

    T = 16
    bounds = np.linspace(0, m, T + 1).astype(np.int64)
    starts, lens = bounds[1:] - 1, np.diff(bounds)
    seeds = np.zeros(T, np.int64)
    seeds[T - 1] = isa_m
    return mk, starts, lens, seeds, m


@pytest.mark.parametrize("sigma", [4, 16])
def test_sharded_occ_matches_single_device(sigma):
    # sigma=4 exercises the bit-plane rows, sigma=16 the byte-row FusedOcc
    mk, starts, lens, seeds, m = _setup(sigma, seed=31, rate=512)
    T = len(starts)

    r1 = mk()
    vals1, ok1 = r1.anchor(starts[: T - 1], 256)
    assert ok1.all()
    seeds1 = seeds.copy()
    seeds1[: T - 1] = vals1
    r1.run_chains(starts, seeds1, lens)
    gap1 = np.asarray(r1.gap, np.int64).reshape(-1)[: m + 1]
    pos1, val1 = r1.harvest_samples()

    mesh = make_mesh(8)
    r2 = mk()
    sh = ShardedOccGapRunner(mesh, r2)
    # rows really are distributed: each shard holds 1/8 of the row space
    assert len(sh.focc_sh.rows.sharding.device_set) == 8
    vals2, ok2 = sh.anchor(starts[: T - 1], 256)
    assert ok2.all()
    assert np.array_equal(vals1, vals2)
    seeds2 = seeds.copy()
    seeds2[: T - 1] = vals2
    gap2 = sh.run_chains(starts, seeds2, lens)
    assert np.array_equal(gap2, gap1)
    assert gap2.sum() == m
    assert np.array_equal(r2.final_rs, r1.final_rs)
    pos2, val2 = r2.harvest_samples()
    assert np.array_equal(pos1, pos2)
    assert np.array_equal(val1, val2)
    # downstream consumers see the same compressed gap
    g8a, ia, va = r1.fetch_gap_compressed()
    g8b, ib, vb = r2.fetch_gap_compressed()
    assert np.array_equal(g8a, g8b)
    assert np.array_equal(ia, ib) and np.array_equal(va, vb)


def test_sharded_occ_full_merge_bit_identity():
    """Whole scaled build with the occ-sharded executor vs single device."""
    import os
    from bwtb3m.engine.merge_scaled import blockwise_bwt_scaled
    from bwtb3m.engine.options import BwtOptions

    rng = np.random.default_rng(7)
    n = 6 * 1024
    text = rng.integers(0, 4, n).astype(np.uint8)
    opts = BwtOptions(input_path="", output_filename="/tmp/shocc_t",
                      max_block_symbols=2048)
    bwt1, p1, r1, h1 = blockwise_bwt_scaled(text, 4, opts, sample_rate=256)
    mesh = make_mesh(8)
    os.environ["BWTB3M_SHARD_OCC"] = "1"
    try:
        bwt2, p2, r2, h2 = blockwise_bwt_scaled(
            text, 4, opts, sample_rate=256, mesh=mesh)
    finally:
        del os.environ["BWTB3M_SHARD_OCC"]
    assert np.array_equal(bwt1, bwt2)
    assert np.array_equal(p1, p2) and np.array_equal(r1, r2)
    assert np.array_equal(h1, h2)

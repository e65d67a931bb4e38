"""Lane-sharded gap chains on the virtual CPU mesh vs the single-device
runner (the multi-chip merge engine path, SURVEY.md section 2.3.3)."""

import numpy as np
import pytest

from bwtb3m.ops.doubling import suffix_array
from bwtb3m.ops.focc import build_focc
from bwtb3m.ops.gapdev import DeviceGapRunner, build_text_rows, upload_bwt
from bwtb3m.parallel import make_mesh
from bwtb3m.parallel.merge import ShardedGapRunner


def test_sharded_chains_match_single_device():
    rng = np.random.default_rng(21)
    n = 1 << 14
    text = rng.integers(0, 4, n).astype(np.uint8)
    sa, isa, _ = suffix_array(text.astype(np.int32), 4)
    sa, isa = np.asarray(sa), np.asarray(isa)
    m = n // 2
    sel = sa[(sa >= m)]
    right_bwt = text[(sel - 1) % n]
    focc = build_focc(upload_bwt(right_bwt, 4), 4)
    isa_m = int(np.flatnonzero(sel == m)[0])
    trows = build_text_rows(text)
    hist = np.bincount(text[m:], minlength=4).astype(np.int64)

    def mkrunner(bucket):
        return DeviceGapRunner(
            focc, trows, text, 0, m, n, isa_m, hist,
            lane_bucket=bucket, sample_rate=0)

    T = 16
    bounds = np.linspace(0, m, T + 1).astype(np.int64)
    starts, lens = bounds[1:] - 1, np.diff(bounds)
    seeds = np.zeros(T, np.int64)
    seeds[T - 1] = isa_m
    r1 = mkrunner(64)
    vals, ok = r1.anchor(starts[: T - 1], 256)
    assert ok.all()
    seeds[: T - 1] = vals
    r1.run_chains(starts, seeds, lens)
    gap_single = np.asarray(r1.gap, dtype=np.int64).reshape(-1)[: m + 1]

    mesh = make_mesh(8)
    r2 = mkrunner(64)
    sharded = ShardedGapRunner(mesh, r2)
    gap_mesh = sharded.run_chains(starts, seeds, lens)
    assert np.array_equal(gap_mesh, gap_single)
    assert gap_mesh.sum() == m

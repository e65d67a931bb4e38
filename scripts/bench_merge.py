"""Merge-engine benchmark: 16M / 4-block scaled blockwise build + isolated
root merge.

Usage: PYTHONPATH=. python scripts/bench_merge.py [n_mb] [lanes]
"""

import sys
import time

import numpy as np


def main():
    n = (int(sys.argv[1]) if len(sys.argv) > 1 else 16) * 1024 * 1024
    lanes = int(sys.argv[2]) if len(sys.argv) > 2 else 1 << 16
    import jax

    print("devices:", jax.devices())
    from bwtb3m.engine.options import BwtOptions
    import bwtb3m.engine.merge_scaled as ms
    from bwtb3m.util.log import VerboseLog
    from bwtb3m.ops.focc import build_focc
    from bwtb3m.ops.gapdev import DeviceGapRunner, upload_bwt

    rng = np.random.default_rng(0)
    text = rng.integers(0, 4, n).astype(np.uint8)
    opts = BwtOptions(input_path="x", output_filename="/tmp/bm.bwt",
                      max_block_symbols=n // 4)
    log = VerboseLog(1)

    t0 = time.time()
    bwt, spos, srank, hist = ms.blockwise_bwt_scaled(
        text, 4, opts, log, sample_rate=1024, lane_bucket=lanes)
    t_full_warm = time.time() - t0
    print("full scaled 16M/4-block tree (incl. compile): %.1fs" % t_full_warm)

    # steady-state rerun
    t0 = time.time()
    bwt2, spos2, srank2, _ = ms.blockwise_bwt_scaled(
        text, 4, opts, log, sample_rate=1024, lane_bucket=lanes)
    t_full = time.time() - t0
    print("full scaled %dM/4-block tree steady: %.2fs" % (n >> 20, t_full))
    assert np.array_equal(bwt, bwt2)

    # correctness vs doubling engine
    from bwtb3m.ops.doubling import suffix_array
    t0 = time.time()
    sa, isa, bwt_d = suffix_array(text.astype(np.int32), 4)
    t_doub = time.time() - t0
    print("doubling engine same text: %.2fs" % t_doub)
    assert np.array_equal(bwt.astype(np.int64), np.asarray(bwt_d, np.int64))
    assert np.array_equal(srank, np.asarray(isa)[spos])
    print("bit-identical to doubling engine: OK")

    # isolated root merge (n/2 into n/2) timing breakdown
    ctx = ms._Ctx(text, 4, 1024, opts, log, lanes)
    half = ((n // 2) // 256) * 256
    t0 = time.time()
    sa_np = np.asarray(sa)
    rank_all = np.asarray(isa)

    def mkregion(s, e):
        sel = sa_np[(sa_np >= s) & (sa_np < e)]
        bwtr = text[(sel - 1) % n]
        inv = {}
        first = (-s) % 1024
        ps = np.arange(s + first, e, 1024, dtype=np.int64)
        local = np.argsort(np.argsort(rank_all[np.arange(s, e)]))
        return ms._RegionS(s, e, bwtr, ps, local[ps - s], int(local[0]),
                           np.bincount(text[s:e], minlength=4).astype(np.int64))

    left = mkregion(0, half)
    right = mkregion(half, n)
    print("region prep: %.1fs" % (time.time() - t0))
    for trial in range(2):
        t0 = time.time()
        merged = ms._merge_pair_scaled(ctx, left, right)
        dt = time.time() - t0
        qps = half / dt
        print("root merge %dM->%dM: %.2fs  (%.2e chain queries/s)"
              % (half >> 20, (n - half) >> 20, dt, qps))
    tb, = (text[(sa_np - 1) % n],)
    assert np.array_equal(ms._region_bwt(ctx, merged), tb.astype(np.uint8))
    print("root merge bit-exact: OK")


if __name__ == "__main__":
    main()

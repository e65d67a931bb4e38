"""Randomized cross-engine consistency fuzz.

All four construction engines (device doubling, tie-compacted LS, legacy
block gap-merge, scaled blockwise merge with random geometry) against the
brute-force rotation-sort oracle, over random / run-heavy / periodic /
fibonacci-like texts.

Usage: python scripts/fuzz_engines.py [seconds] [seed]
"""

import os
import sys
import tempfile
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tests"))


def main():
    import jax
    try:
        jax.config.update("jax_platforms", "cpu")
    except RuntimeError:
        pass
    from oracle import naive_bwt, naive_circular_sa

    from bwtb3m.engine.merge import blockwise_bwt
    from bwtb3m.engine.merge_scaled import blockwise_bwt_scaled
    from bwtb3m.engine.options import BwtOptions
    from bwtb3m.ops.doubling import suffix_array, suffix_array_ls
    from bwtb3m.util.log import VerboseLog

    budget = float(sys.argv[1]) if len(sys.argv) > 1 else 120.0
    seed = int(sys.argv[2]) if len(sys.argv) > 2 else 12345
    rng = np.random.default_rng(seed)
    t_end = time.time() + budget
    work = tempfile.mkdtemp()
    iters = fails = 0
    while time.time() < t_end:
        iters += 1
        kind = rng.integers(0, 4)
        n = int(rng.integers(8, 400))
        sigma = int(rng.choice([2, 3, 4, 5, 8, 27, 200]))
        if kind == 0:
            text = rng.integers(0, sigma, n).astype(np.int32)
        elif kind == 1:
            text = np.repeat(rng.integers(0, sigma, max(1, n // 5)),
                             rng.integers(1, 10, max(1, n // 5)))[:n].astype(np.int32)
            if len(text) < 8:
                continue
            n = len(text)
        elif kind == 2:
            period = rng.integers(1, 6)
            text = np.tile(rng.integers(0, sigma, period),
                           n // period + 1)[:n].astype(np.int32)
            if rng.random() < 0.5 and n > 3:
                text[rng.integers(0, n)] = rng.integers(0, sigma)
        else:
            a, b = [0], [0, 1]
            while len(b) < n:
                a, b = b, b + a
            text = np.array(b[:n], np.int32) % sigma
        sigma_eff = int(text.max()) + 1
        ref_sa = naive_circular_sa(text)
        ref_bwt = naive_bwt(text)
        sa, _isa, bwt = suffix_array(text, sigma_eff)
        ok_a = np.array_equal(sa, ref_sa) and np.array_equal(bwt, ref_bwt)
        sa2, _bwt2 = suffix_array_ls(text, sigma_eff)
        ok_ls = np.array_equal(np.asarray(sa2), ref_sa)
        mb = int(rng.integers(max(8, n // 6), max(9, n // 2)))
        opts = BwtOptions(input_path=work + "/x",
                          output_filename=work + "/x.bwt",
                          max_block_symbols=mb, large_lcp_thres=32)
        sam, _isam, bwtm = blockwise_bwt(
            text, sigma_eff, opts, VerboseLog(0),
            num_segments=int(rng.choice([1, 2, 3, 7])),
            anchor_lookback=int(rng.choice([4, 16, 64])),
            merge_mode=str(rng.choice(["tree", "fold"])))
        ok_m = np.array_equal(sam, ref_sa) and np.array_equal(bwtm, ref_bwt)
        ok_s = True
        if sigma_eff <= 16:
            rate = int(rng.choice([4, 32, 128]))
            bwts, spos, srank, _h = blockwise_bwt_scaled(
                text, sigma_eff, opts, VerboseLog(0), sample_rate=rate,
                lane_bucket=int(rng.choice([4, 16, 64])))
            isa_ref = np.empty(n, np.int64)
            isa_ref[ref_sa] = np.arange(n)
            ok_s = (np.array_equal(bwts.astype(np.int64),
                                   ref_bwt.astype(np.int64))
                    and np.array_equal(srank, isa_ref[spos]))
        if not (ok_a and ok_ls and ok_m and ok_s):
            fails += 1
            path = os.path.join(work, "fuzz_fail_%d.npy" % iters)
            np.save(path, text)
            print("FAIL iter=%d kind=%d n=%d sigma=%d -> %s"
                  % (iters, kind, n, sigma_eff, path))
            if fails > 3:
                break
    print("fuzz: %d iterations, %d failures" % (iters, fails))
    return 1 if fails else 0


if __name__ == "__main__":
    sys.exit(main())

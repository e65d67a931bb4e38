"""Repetitive-text throughput for the scaled engine: the memory bound
holds, and the repetitive rate against the random one.

16 Mbp text of 64KB segments repeated with 1% mutations through the scaled blockwise engine, vs the
same-size random text.

Usage: PYTHONPATH=. python scripts/bench_rep.py
"""

import time

import numpy as np


def make_repetitive(n, seg=65536, mut=0.01, seed=3):
    rng = np.random.default_rng(seed)
    s = rng.integers(0, 4, seg, dtype=np.uint8)
    text = np.tile(s, n // seg + 1)[:n].copy()
    idx = rng.integers(0, n, int(n * mut))
    text[idx] = rng.integers(0, 4, len(idx), dtype=np.uint8)
    return text


def run(text, label):
    from bwtb3m.engine.options import BwtOptions
    from bwtb3m.engine.merge_scaled import blockwise_bwt_scaled
    from bwtb3m.util.log import VerboseLog
    n = len(text)
    opts = BwtOptions(input_path="x", output_filename="/tmp/rep.bwt",
                      max_block_symbols=n // 4)
    best = float("inf")
    for _ in range(2):
        t0 = time.time()
        bwt, spos, srank, _ = blockwise_bwt_scaled(
            text.astype(np.int32), 4, opts, VerboseLog(1), sample_rate=1024)
        best = min(best, time.time() - t0)
    print("%s: %.2fs (%.2f Mbp/s)" % (label, best, n / 1e6 / best))
    return best, bwt


def main():
    n = 16 * 1024 * 1024
    rng = np.random.default_rng(0)
    t_rand, _ = run(rng.integers(0, 4, n, dtype=np.uint8), "random 16M")
    rep = make_repetitive(n)
    t_rep, bwt = run(rep, "repetitive 16M (64K segs, 1% mut)")
    # correctness on the repetitive text
    from bwtb3m.ops.doubling import suffix_array
    _sa, _isa, bwt_d = suffix_array(rep.astype(np.int32), 4)
    assert np.array_equal(bwt.astype(np.int64), np.asarray(bwt_d, np.int64))
    print("bit-exact on repetitive: OK; ratio %.2fx" % (t_rep / t_rand))


if __name__ == "__main__":
    main()

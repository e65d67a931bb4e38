"""Walk-phase benchmark at 100M: checkbwt + bwtcomputessa on the fused
rank structure.

Usage: PYTHONPATH=. python scripts/bench_walks.py [Mbp]
"""

import os
import sys
import tempfile
import time

import numpy as np


def main():
    mbp = int(sys.argv[1]) if len(sys.argv) > 1 else 100
    n = mbp * 1000 * 1000
    work = tempfile.mkdtemp(prefix="walks")
    from bwtb3m.engine import (BwtOptions, check_bwt, compute_bwt,
                                   compute_ssa)
    rng = np.random.default_rng(0)
    raw = rng.choice(np.frombuffer(b"ACGT", np.uint8), size=n)
    p = os.path.join(work, "t.bin")
    open(p, "wb").write(raw.tobytes())
    t0 = time.time()
    res = compute_bwt(BwtOptions(input_path=p, bwt_only=True,
                                 preisa_sampling_rate=1024,
                                 max_block_symbols=1 << 31))
    print("construct+encode: %.1fs" % (time.time() - t0))
    text = raw.astype(np.int32)
    for trial in range(2):
        t0 = time.time()
        ok = check_bwt(res, text)
        print("checkbwt (all %d positions): %.2fs ok=%s"
              % (n, time.time() - t0, ok))
    assert ok
    for trial in range(2):
        t0 = time.time()
        compute_ssa(res.bwt_path, 32, 32)
        print("bwtcomputessa (sa rate 32): %.2fs" % (time.time() - t0))


if __name__ == "__main__":
    main()

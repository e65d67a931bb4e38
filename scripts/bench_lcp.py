"""lcpbit at scale: build + verify the succinct PLCP for a 100M text on
one device with the O(n)-memory batched-Kasai path.

Usage: PYTHONPATH=. python scripts/bench_lcp.py [Mbp]
"""

import os
import sys
import tempfile
import time

import numpy as np


def main():
    mbp = int(sys.argv[1]) if len(sys.argv) > 1 else 100
    n = mbp * 1000 * 1000
    rng = np.random.default_rng(0)
    text = rng.integers(0, 4, n).astype(np.int32)

    from bwtb3m.lcp.plcp import (compute_plcp_scaled, encode_plcp_bits,
                                     write_plcp_file, PLCPBitDecoder)
    from bwtb3m import native

    t0 = time.time()
    plcp, sa = compute_plcp_scaled(text, 4)
    t_build = time.time() - t0
    print("PLCP compute (SA + batched Kasai): %.1fs (%.1f Mbp/s)"
          % (t_build, n / 1e6 / t_build))

    work = tempfile.mkdtemp(prefix="lcp")
    path = os.path.join(work, "t.lcpbit")
    t0 = time.time()
    write_plcp_file(path, plcp)
    print("encode+write .lcpbit: %.1fs (%.1f MB)"
          % (time.time() - t0, os.path.getsize(path) / 1e6))

    # independent verification (checkLCPBit role): native Kasai oracle
    t0 = time.time()
    ref = native.kasai_plcp(text, sa)
    dec = PLCPBitDecoder(path, n=n)
    ok = bool(np.array_equal(dec.all(), ref))
    print("checkLCPBit (native Kasai oracle): ok=%s in %.1fs"
          % (ok, time.time() - t0))
    assert ok


if __name__ == "__main__":
    main()

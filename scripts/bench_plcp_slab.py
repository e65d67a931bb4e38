"""PLCP Kasai-machine pathology probe: does the per-chunk cost scale
with the SLAB SIZE (scatter/gather target arrays) rather than with the
step count?

If a large run is far below what
the kernel's per-step op mix (2 text row gathers + 2 element gathers +
1 scatter per step) should cost next to the LF walk's 9e7 steps/s.
Suspect: the [slab+1] uint32 plcp carry (1 GB at slab=2^28) being
copied (not updated in place) per scatter inside the fori_loop, or the
1 GB phi/isa gather operands.  If true, per-chunk time grows with slab
while per-position work is constant — and the fix is simply a smaller
slab (more, cheaper chunks).

Usage: PYTHONPATH=. \
           python scripts/bench_plcp_slab.py [n]
"""

import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main():
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 1 << 26
    sigma = 5
    rng = np.random.default_rng(0)
    text = rng.integers(0, sigma, n).astype(np.int32)

    from bwtb3m.lcp.plcp import compute_plcp_scaled, kasai_plcp
    from bwtb3m.ops.doubling import suffix_array

    t0 = time.time()
    sa, isa, _ = suffix_array(text, sigma)
    sa = np.asarray(sa)
    isa = np.asarray(isa).astype(np.int64)
    print("sa %.1fs" % (time.time() - t0), flush=True)

    ref = None
    for slab in (n, n // 4, n // 16, n // 64):
        t0 = time.time()
        plcp, _ = compute_plcp_scaled(text, sigma, sa_isa=(sa, isa),
                                      slab_positions=slab)
        dt = time.time() - t0
        nslabs = (n + slab - 1) // slab
        print("slab=%-10d (%d slabs)  %.2fs  %.3f Mbp/s"
              % (slab, nslabs, dt, n / dt / 1e6), flush=True)
        if ref is None:
            ref = plcp
        else:
            assert np.array_equal(plcp, ref), "slab size changed the result"
    # ground truth on the smallest run only (host Kasai is slow)
    if n <= (1 << 24):
        assert np.array_equal(ref, kasai_plcp(text, sa))
        print("verified vs host Kasai", flush=True)


if __name__ == "__main__":
    main()

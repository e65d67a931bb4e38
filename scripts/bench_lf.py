"""LF-walk throughput benchmark (the gap/verify/SSA kernel).

Usage: python scripts/bench_lf.py [n] [steps]
Prints steps/s for a ladder of lane counts on the default device.
"""

import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main():
    import jax.numpy as jnp

    from bwtb3m.ops.doubling import bwt_from_sa, suffix_array_jax
    from bwtb3m.ops.lf import lf_walk
    from bwtb3m.ops.rank import build_occ

    n = int(sys.argv[1]) if len(sys.argv) > 1 else 1 << 22
    steps = int(sys.argv[2]) if len(sys.argv) > 2 else 256
    rng = np.random.default_rng(0)
    sym = jnp.asarray(rng.integers(0, 4, n, dtype=np.int32))
    sa, _ = suffix_array_jax(sym, 4)
    bwt = bwt_from_sa(sym, sa)
    occt = build_occ(bwt, 4)
    b = 1024
    while b <= (1 << 17):
        r0 = jnp.asarray(rng.integers(0, n, b).astype(np.int32))
        out, _ = lf_walk(occt, r0, steps)
        int(jnp.sum(out))  # compile + force
        t0 = time.time()
        for _ in range(3):
            out, _ = lf_walk(occt, r0, steps)
        int(jnp.sum(out))
        dt = (time.time() - t0) / 3
        print("lanes=%-7d steps=%d  %.4fs  %.3e LF-steps/s"
              % (b, steps, dt, b * steps / dt), flush=True)
        b *= 8


if __name__ == "__main__":
    main()

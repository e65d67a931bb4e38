"""Walk-kernel locality probe in the REAL regime: the shipping
checkbwt-shaped loop (v0 of bench_walk.py) with lane ranks optionally
confined to a power-of-two window of the rank space after every LF step
(one extra AND+ADD per step — noise).

Where the walk's steps/s fall as the text grows, the isolated gather probe (bench_gather.py) could not
resolve whether locality is the cause (its own per-iteration overhead
floors it at ~8e7 rows/s regardless of index order).  Here the kernel is
the production one: if confining the gathers of a 256M structure to a
16M-sized window restores the 16M rate, strip-mined walks pay; if not,
the falloff is the dependent HBM row gather itself and the large-n rate
IS the speed of light on this toolchain.

Usage: PYTHONPATH=. \
           python scripts/bench_walk_window.py [n] [lanes] [steps]
"""

import os
import sys
import time
from functools import partial

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main():
    import jax
    import jax.numpy as jnp
    from jax import lax

    from bwtb3m.ops.focc import lf_step_batch_f
    from bwtb3m.ops.focc_build import build_focc_host

    n = int(sys.argv[1]) if len(sys.argv) > 1 else 1 << 28
    lanes = int(sys.argv[2]) if len(sys.argv) > 2 else 1 << 17
    steps = int(sys.argv[3]) if len(sys.argv) > 3 else 2048
    sigma = 5
    rng = np.random.default_rng(0)
    bwt = rng.integers(0, sigma, n).astype(np.int8)
    t0 = time.time()
    focc = build_focc_host(bwt, sigma)
    print("focc build %.1fs (n=%d)" % (time.time() - t0, n), flush=True)

    T = lanes
    r0 = rng.integers(0, n, T).astype(np.uint32)
    outer = steps // 256

    @partial(jax.jit, static_argnums=(0, 1))
    def walk(outer, wmask, focc, r, base):
        def outer_body(carry, o):
            r, acc = carry

            def inner(i, carry):
                r, acc = carry
                sym, r2 = lf_step_batch_f(focc, r)
                if wmask is not None:
                    r2 = base + (r2 & jnp.uint32(wmask))
                return (r2, acc + sym)

            return lax.fori_loop(0, 256, inner, (r, acc)), 0

        (r, acc), _ = lax.scan(outer_body, (r, jnp.zeros(T, jnp.int32)),
                               jnp.arange(outer, dtype=jnp.int32))
        return jnp.sum(acc) + jnp.sum(r)

    if len(sys.argv) > 4:          # explicit window list, "full" or log2
        windows = [None if a == "full" else 1 << int(a)
                   for a in sys.argv[4].split(",")]
        for w in windows:
            if w is not None and w >= n:
                # base = (n - w) // 2 would go negative and wrap through
                # np.uint32 — the probe would silently walk garbage ranks
                sys.exit("window 2^%d >= n=%d: pass 'full' for the "
                         "unconfined walk" % (w.bit_length() - 1, n))
    else:
        windows = [None] + [w for w in (1 << 24, 1 << 20, 1 << 16)
                            if w < n]
    for w in windows:
        wmask = None if w is None else w - 1
        base = jnp.uint32(0 if w is None else (n - w) // 2)
        rj = jnp.asarray(r0 if w is None
                         else (r0 % np.uint32(w)) + np.uint32(base))
        fn = lambda: int(walk(outer, wmask, focc, rj, base))
        fn()
        times = []
        for _ in range(3):
            t1 = time.time()
            fn()
            times.append(time.time() - t1)
        dt = min(times)
        print("window=%-10s lanes=%d steps=%d  %.4fs  %.3e steps/s"
              % ("full" if w is None else str(w), T, steps, dt,
                 T * steps / dt), flush=True)


if __name__ == "__main__":
    main()

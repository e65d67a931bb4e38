"""A/B bench: byte-row FusedOcc vs bit-plane popcount rank (ops/focc_bp).

Times the dependent-LF-walk kernel (the checkbwt/ssa/gap hot loop,
reference /root/reference/src/bwttestdecodespeed.cpp:67-97) over a lane
ladder, steady-state, forcing completion with an on-device checksum +
scalar fetch.

Usage: PYTHONPATH=. python scripts/bench_lf2.py \
           [n] [steps]
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

    from bwtb3m.ops.focc import BLOCK, _build_focc_jax, _pad_rows
    from bwtb3m.ops.focc import lf_step_batch_f
    from bwtb3m.ops.focc_bp import build_focc_bp, lf_step_batch_bp2

    n = int(sys.argv[1]) if len(sys.argv) > 1 else 1 << 22
    steps = int(sys.argv[2]) if len(sys.argv) > 2 else 256
    sigma = 5
    rng = np.random.default_rng(0)
    bwt = rng.integers(0, sigma, n).astype(np.int8)
    nb = (n + BLOCK - 1) // BLOCK
    structs = {
        "byte-row": _build_focc_jax(jnp.asarray(bwt), sigma, BLOCK,
                                    _pad_rows(nb + 1)),
        "bit-plane": build_focc_bp(jnp.asarray(bwt), sigma),
    }

    structs["bp-fused2"] = structs["bit-plane"]

    @partial(jax.jit, static_argnums=(1, 3))
    def walk(focc, steps, r0, fused2=False):
        step = lf_step_batch_bp2 if fused2 else lf_step_batch_f

        def body(i, r):
            _s, r2 = step(focc, r)
            return r2
        return jnp.sum(lax.fori_loop(0, steps, body, r0))

    for name, focc in structs.items():
        fused2 = name == "bp-fused2"
        b = 1 << 14
        while b <= (1 << 19):
            r0 = jnp.asarray(rng.integers(0, n, b).astype(np.uint32))
            int(walk(focc, steps, r0, fused2))   # compile + warm
            times = []
            for _ in range(3):
                t0 = time.time()
                int(walk(focc, steps, r0, fused2))
                times.append(time.time() - t0)
            dt = min(times)
            print("%-9s lanes=%-7d steps=%d  %.4fs  %.3e LF-steps/s"
                  % (name, b, steps, dt, b * steps / dt), flush=True)
            b *= 8


if __name__ == "__main__":
    main()

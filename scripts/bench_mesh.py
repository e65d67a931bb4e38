"""Sharded-engine scaling check on a virtual CPU mesh.

Usage: XLA_FLAGS=--xla_force_host_platform_device_count=8 \
       python scripts/bench_mesh.py [n] [devices...]

Runs the sharded doubling engine at each mesh size, asserts bit-equality
with the single-device path, and reports wall times. (On a virtual CPU
mesh the numbers measure correctness overheads, not real scaling — all
"devices" share the host; true scaling needs a pod slice.)
"""

import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main():
    import jax

    # the virtual CPU mesh, whatever accelerator the host has
    jax.config.update("jax_platforms", "cpu")

    from bwtb3m.ops.doubling import suffix_array
    from bwtb3m.parallel import make_mesh, sharded_bwt

    n = int(sys.argv[1]) if len(sys.argv) > 1 else 1 << 18
    sizes = [int(a) for a in sys.argv[2:]] or [1, 2, 4, 8]
    rng = np.random.default_rng(0)
    text = rng.integers(0, 4, n, dtype=np.int32)

    t0 = time.time()
    sa1, _isa, bwt1 = suffix_array(text, 4)
    print("single-device: %.2fs" % (time.time() - t0), flush=True)

    for d in sizes:
        if d > len(jax.devices()):
            print("skipping d=%d (only %d devices)" % (d, len(jax.devices())))
            continue
        mesh = make_mesh(d)
        t0 = time.time()
        sa, _r, bwt = sharded_bwt(text, 4, mesh)
        dt = time.time() - t0
        ok = np.array_equal(sa, sa1) and np.array_equal(bwt, bwt1)
        print("mesh d=%d: %.2fs  bit-identical=%s" % (d, dt, ok), flush=True)
        assert ok


if __name__ == "__main__":
    main()

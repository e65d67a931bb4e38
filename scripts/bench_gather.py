"""Row-gather locality probe: does sorting the lane indices speed the
one-row-per-query gather once the rank rows live in HBM?

If the walk's steps/s fall as the text grows past what stays in cache,
the rank rows have outgrown on-chip residency. If the
HBM gather is faster on ascending indices, the walk loops can sort the
lane population per chunk (two extra 131k-key sorts per 2048 steps) and
unsort the carry.

Usage: PYTHONPATH=. python scripts/bench_gather.py [nrows] [B]
"""

import sys
import time

import numpy as np


def main():
    import jax
    import jax.numpy as jnp

    nrows = int(sys.argv[1]) if len(sys.argv) > 1 else 1 << 20   # 128 MB
    B = int(sys.argv[2]) if len(sys.argv) > 2 else 1 << 17
    reps = 64
    rng = np.random.default_rng(0)
    rows = jnp.asarray(
        rng.integers(-128, 128, (nrows, 128), dtype=np.int8))

    @jax.jit
    def gsum(idx):
        # chained gathers: each repetition depends on the previous sum,
        # so XLA cannot batch them; mimics the walk's dependent step
        def body(c, i):
            g = jnp.take(rows, (idx + c) % nrows, axis=0)
            s = jnp.sum(g.astype(jnp.int32))
            return s % 2, 0

        c, _ = jax.lax.scan(body, jnp.int32(0), jnp.arange(reps))
        return c

    idx_rand = jnp.asarray(rng.integers(0, nrows, B, dtype=np.int32))
    idx_sort = jnp.sort(idx_rand)
    idx_seq = jnp.arange(B, dtype=jnp.int32) * jnp.int32(max(1, nrows // B))

    for name, idx in (("random", idx_rand), ("sorted", idx_sort),
                      ("strided", idx_seq)):
        _ = int(gsum(idx))          # compile + warm
        times = []
        for _r in range(3):
            t0 = time.time()
            _ = int(gsum(idx))
            times.append(time.time() - t0)
        dt = min(times)
        per = B * reps / dt
        print("%-8s nrows=%d B=%d  %.3fs  %.3e rows/s  (%.1f GB/s)"
              % (name, nrows, B, dt, per, per * 128 / 1e9), flush=True)


if __name__ == "__main__":
    main()

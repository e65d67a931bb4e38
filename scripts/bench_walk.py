"""Walk-kernel variant ladder: checkbwt-shaped loop A/B.

Where the checkbwt/ssa pipelines run slower per LF step than the bare
LF ladder, the suspects are per-iteration kernel count (text dynamic-slice reads,
multi-reduce LF arithmetic) rather than bandwidth.  This bench times the
verify-chunk loop in variants:

  v0  shipping _verify_chunk (per-step dynamic_slice text read,
      naive 4-reduce LF)
  v1  scan-sliced text: per-window unpack+flip+transpose of the text
      rows, expected symbols delivered as lax.scan operands
  v2  v1 + the two-reduction fused LF arithmetic (focc_bp.lf_step_words_fused)

Usage: PYTHONPATH=. python scripts/bench_walk.py \
           [n] [lanes] [steps]
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
    from bwtb3m.ops.focc_bp import lf_step_words_fused, _gather_words
    from bwtb3m.ops.focc_build import build_focc_host
    from bwtb3m.ops.gapdev import build_text_rows

    n = int(sys.argv[1]) if len(sys.argv) > 1 else 1 << 24
    lanes = int(sys.argv[2]) if len(sys.argv) > 2 else 1 << 17
    steps = int(sys.argv[3]) if len(sys.argv) > 3 else 2048
    sigma = 5
    rng = np.random.default_rng(0)
    text = rng.integers(0, sigma, n).astype(np.uint8)
    bwt = rng.integers(0, sigma, n).astype(np.int8)   # shape-only stand-in
    # chunked production builder: the monolithic jit OOMs past ~512M
    # (16 GB padded bit-shift temp)
    focc = build_focc_host(bwt, sigma)
    text_rows = build_text_rows(text, sigma)

    T = lanes
    starts = rng.integers(0, n // 256, T).astype(np.int32)  # absolute rows
    r0 = rng.integers(0, n, T).astype(np.uint32)

    outer = steps // 256

    @partial(jax.jit, static_argnums=(0,))
    def v0(outer, focc, text_rows, start_rows, r, bad, k0):
        def outer_body(carry, o):
            r, bad = carry
            kbase = k0 + o * 256
            prow = start_rows - (kbase >> 8)
            trow = jnp.take(text_rows,
                            jnp.minimum(jnp.maximum(prow, 0),
                                        text_rows.shape[0] - 1), axis=0)

            def inner(i, carry):
                r, bad = carry
                sym, r2 = lf_step_batch_f(focc, r)
                col = 255 - i
                byte = lax.dynamic_slice_in_dim(
                    trow, col >> 1, 1, axis=1)[:, 0].astype(jnp.int32) & 0xFF
                expect = (byte >> ((col & 1) * 4)) & 0xF
                bad = bad + (sym != expect).astype(jnp.int32)
                return (r2, bad)

            return lax.fori_loop(0, 256, inner, (r, bad)), 0

        (r, bad), _ = lax.scan(outer_body, (r, bad),
                               jnp.arange(outer, dtype=jnp.int32))
        return jnp.sum(bad) + jnp.sum(r)

    def unpack_flip(trow):
        # [T, 128] nibble rows -> [256, T] int32 symbols, column-reversed
        b = trow.astype(jnp.int32) & 0xFF
        lo = b & 0xF
        hi = b >> 4
        syms = jnp.stack([lo, hi], axis=2).reshape(b.shape[0], 256)
        return jnp.flip(syms, axis=1).T            # [256, T]

    @partial(jax.jit, static_argnums=(0, 7))
    def v12(outer, focc, text_rows, start_rows, r, bad, k0, fused):
        def outer_body(carry, o):
            r, bad = carry
            kbase = k0 + o * 256
            prow = start_rows - (kbase >> 8)
            trow = jnp.take(text_rows,
                            jnp.minimum(jnp.maximum(prow, 0),
                                        text_rows.shape[0] - 1), axis=0)
            exp = unpack_flip(trow)                # [256, T]

            def inner(carry, expect):
                r, bad = carry
                if fused:
                    words, off = _gather_words(focc, r)
                    sym, r2 = lf_step_words_fused(focc, words, off)
                else:
                    sym, r2 = lf_step_batch_f(focc, r)
                bad = bad + (sym != expect).astype(jnp.int32)
                return (r2, bad), 0

            (r, bad), _ = lax.scan(inner, (r, bad), exp)
            return (r, bad), 0

        (r, bad), _ = lax.scan(outer_body, (r, bad),
                               jnp.arange(outer, dtype=jnp.int32))
        return jnp.sum(bad) + jnp.sum(r)

    srj = jnp.asarray(starts)
    rj = jnp.asarray(r0)
    bad0 = jnp.zeros(T, jnp.int32)
    variants = {
        "v0-ship": lambda: int(v0(outer, focc, text_rows, srj, rj, bad0,
                                  jnp.int32(0))),
        "v1-scan": lambda: int(v12(outer, focc, text_rows, srj, rj, bad0,
                                   jnp.int32(0), False)),
        "v2-scan+fused": lambda: int(v12(outer, focc, text_rows, srj, rj,
                                         bad0, jnp.int32(0), True)),
    }
    for name, fn in variants.items():
        fn()          # compile + warm
        times = []
        for _ in range(3):
            t0 = time.time()
            fn()
            times.append(time.time() - t0)
        dt = min(times)
        print("%-14s lanes=%-7d steps=%d  %.4fs  %.3e steps/s"
              % (name, T, steps, dt, T * steps / dt), flush=True)


if __name__ == "__main__":
    main()

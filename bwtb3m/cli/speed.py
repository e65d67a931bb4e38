"""bwttestdecodespeed: LF-step throughput benchmark.

The reference (/root/reference/src/bwttestdecodespeed.cpp:67-97) measures
LF-step throughput for 1..8 *interleaved independent walk streams* — an ILP
experiment showing memory-latency hiding. The device analog scales the stream
count by orders of magnitude: we measure batched LF walks at 1..MAXSTREAMS
lanes on device, printing steps/s per configuration.
"""

from __future__ import annotations

import sys
import time
from typing import List

import numpy as np

from ..engine.result import BwtResult
from ..util.args import ArgInfo
from ..util.log import VerboseLog
from . import tool


@tool("bwttestdecodespeed")
def bwttestdecodespeed(argv: List[str]) -> int:
    ai = ArgInfo(argv, "bwttestdecodespeed")
    if not ai.restargs:
        sys.stderr.write(
            "usage: bwttestdecodespeed [steps=4096] [maxstreams=4096] <in.bwt>\n")
        return 1
    import jax
    import jax.numpy as jnp

    from ..ops.lf import lf_walk

    steps = ai.get_int("steps", 4096)
    maxstreams = ai.get_int("maxstreams", 4096)
    log = VerboseLog(ai.get_int("verbose", 1))
    result = BwtResult.load(ai.restargs[0])
    occt, _symmap = result.load_occ(dense=True)
    n = result.n
    rng = np.random.default_rng(0)

    streams = []
    b = 1
    while b <= maxstreams:
        streams.append(b)
        b *= 8
    for nstreams in streams:
        r0 = jnp.asarray(rng.integers(0, n, nstreams).astype(np.int32))
        # warmup/compile
        rfin, _ = lf_walk(occt, r0, steps)
        np.asarray(rfin)
        t0 = time.time()
        rfin, _ = lf_walk(occt, r0, steps)
        np.asarray(rfin)
        dt = time.time() - t0
        total = nstreams * steps
        log.m("streams=%-8d steps=%d  %.3fs  %.3e LF-steps/s"
              % (nstreams, steps, dt, total / dt))
    return 0

"""Minimal Python-API walkthrough: build, verify, query.

Run: python examples/python_api.py
"""

import os
import sys
import tempfile

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from bwtb3m.engine import (BwtOptions, check_bwt, compute_bwt,  # noqa: E402
                               compute_ssa)
from bwtb3m.index.fm import FMIndex  # noqa: E402


def main():
    work = tempfile.mkdtemp()
    rng = np.random.default_rng(0)
    text = rng.choice(np.frombuffer(b"ACGT", np.uint8), size=200_000)
    inp = os.path.join(work, "genome.bin")
    text.tofile(inp)

    # 1. construct: .bwt/.hist/.meta/.preisa/.sa/.isa/.hwt
    res = compute_bwt(BwtOptions(
        input_path=inp, input_type="bytestream",
        sa_sampling_rate=32, isa_sampling_rate=64))

    # 2. verify: LF-walks all n positions against the original text
    assert check_bwt(res, text.astype(np.int32)), "verification failed!"

    # 3. or derive sampled SA/ISA later from .bwt + .preisa alone
    compute_ssa(res.bwt_path, sa_sampling_rate=32, isa_sampling_rate=64)

    # 4. query with the FM index
    fm = FMIndex.from_bwt_result(res, structure="hwt")
    pattern = text[5000:5020].astype(np.int64)
    lo, hi = fm.backward_search(pattern)
    positions = fm.locate_range(lo, hi)
    print("pattern occurs %d time(s) at %s" % (hi - lo, positions))
    assert 5000 in positions

    # 5. random-access decode straight from the index
    window = fm.extract(123_456 % len(text), 30)
    assert np.array_equal(window, text[123_456 % len(text):][:30])
    print("extract ok; outputs in", work)


if __name__ == "__main__":
    main()

"""End-to-end engine tests: bwtb3m -> files -> checkbwt -> bwtcomputessa."""

import numpy as np
import pytest

from bwtb3m.engine import (BwtOptions, BwtResult, check_bwt, compute_bwt,
                               compute_ssa)
from bwtb3m.engine.ssa import compute_isa_from_preisa
from bwtb3m.io import formats, rl
from bwtb3m.io.pac import write_pac
from oracle import naive_bwt, naive_circular_sa, random_string


def _write_bytes(tmp_path, data: bytes, name="input.bin"):
    p = tmp_path / name
    p.write_bytes(data)
    return str(p)


def test_end_to_end_bytestream(tmp_path):
    rng = np.random.default_rng(42)
    data = bytes(rng.integers(97, 102, size=4096, dtype=np.uint8))
    inp = _write_bytes(tmp_path, data)
    opts = BwtOptions(input_path=inp, input_type="bytestream",
                      sa_sampling_rate=32, isa_sampling_rate=64,
                      preisa_sampling_rate=256, verbose=0)
    res = compute_bwt(opts)

    text = np.frombuffer(data, np.uint8).astype(np.int32)
    # .bwt decodes to the oracle BWT
    np.testing.assert_array_equal(res.load_bwt(), naive_bwt(text))
    # .hist matches
    hist = formats.read_hist(res.hist_path)
    assert hist == {int(s): int(c) for s, c in
                    zip(*np.unique(text, return_counts=True))}
    # sampled .sa matches oracle SA
    sa = naive_circular_sa(text)
    rate, sa_vals = formats.read_sampled_array(res.sa_path)
    np.testing.assert_array_equal(sa_vals, sa[::rate])
    # checkbwt passes
    assert check_bwt(res, text)


def test_checkbwt_detects_corruption(tmp_path):
    rng = np.random.default_rng(3)
    data = bytes(rng.integers(97, 101, size=1024, dtype=np.uint8))
    inp = _write_bytes(tmp_path, data)
    opts = BwtOptions(input_path=inp, preisa_sampling_rate=128, verbose=0)
    res = compute_bwt(opts)
    text = np.frombuffer(data, np.uint8).astype(np.int32)
    # corrupt the .bwt: swap two adjacent differing symbols
    bwt = res.load_bwt()
    i = int(np.flatnonzero(bwt[1:] != bwt[:-1])[0])
    bwt[i], bwt[i + 1] = bwt[i + 1], bwt[i]
    rl.rl_encode(res.bwt_path, bwt, sigma=res.sigma)
    assert not check_bwt(res, text)


def test_bwtonly_then_computessa(tmp_path):
    rng = np.random.default_rng(9)
    data = bytes(rng.integers(97, 101, size=3000, dtype=np.uint8))
    inp = _write_bytes(tmp_path, data)
    text = np.frombuffer(data, np.uint8).astype(np.int32)

    # full run for the reference SA/ISA files
    full = compute_bwt(BwtOptions(
        input_path=inp, output_filename=str(tmp_path / "full.bwt"),
        sa_sampling_rate=16, isa_sampling_rate=16,
        preisa_sampling_rate=97, verbose=0))

    # bwtonly run, then external-memory-style SSA derivation
    res = compute_bwt(BwtOptions(
        input_path=inp, output_filename=str(tmp_path / "only.bwt"),
        bwt_only=True, preisa_sampling_rate=97, verbose=0))
    assert res.sa_path is None
    sa_path, isa_path = compute_ssa(
        res.bwt_path, sa_sampling_rate=16, isa_sampling_rate=16,
        ref_sa=full.sa_path, ref_isa=full.isa_path)

    sa = naive_circular_sa(text)
    isa = np.zeros(len(sa), np.int64)
    isa[sa] = np.arange(len(sa))
    _, sa_vals = formats.read_sampled_array(sa_path)
    np.testing.assert_array_equal(sa_vals, sa[::16])
    _, isa_vals = formats.read_sampled_array(isa_path)
    np.testing.assert_array_equal(isa_vals, isa[::16])


def test_hwt_preisa_to_isa(tmp_path):
    rng = np.random.default_rng(11)
    data = bytes(rng.integers(65, 70, size=2048, dtype=np.uint8))
    inp = _write_bytes(tmp_path, data)
    res = compute_bwt(BwtOptions(input_path=inp, bwt_only=True,
                                 preisa_sampling_rate=200, verbose=0))
    isa_path = compute_isa_from_preisa(res.bwt_path, isa_sampling_rate=64)
    text = np.frombuffer(data, np.uint8).astype(np.int32)
    sa = naive_circular_sa(text)
    isa = np.zeros(len(sa), np.int64)
    isa[sa] = np.arange(len(sa))
    rate, vals = formats.read_sampled_array(isa_path)
    assert rate == 64
    np.testing.assert_array_equal(vals, isa[::64])


def test_pacterm_end_to_end(tmp_path):
    rng = np.random.default_rng(5)
    codes = rng.integers(0, 4, size=2000, dtype=np.int32)
    pacp = str(tmp_path / "x.pac")
    write_pac(pacp, codes)
    res = compute_bwt(BwtOptions(input_path=pacp, input_type="pacterm",
                                 preisa_sampling_rate=256, verbose=0))
    text = np.concatenate([codes + 1, [0]]).astype(np.int32)
    np.testing.assert_array_equal(res.load_bwt(), naive_bwt(text))
    assert check_bwt(res, text)


def test_result_reload(tmp_path):
    data = b"mississippi" * 50
    inp = _write_bytes(tmp_path, data)
    res = compute_bwt(BwtOptions(input_path=inp, preisa_sampling_rate=64,
                                 verbose=0))
    res2 = BwtResult.load(res.bwt_path)
    assert res2.n == len(data)
    np.testing.assert_array_equal(res2.load_bwt(), res.load_bwt())


def test_select_ssa(tmp_path):
    from bwtb3m.engine.ssa import select_ssa
    rng = np.random.default_rng(17)
    data = bytes(rng.integers(97, 101, size=1200, dtype=np.uint8))
    inp = _write_bytes(tmp_path, data, "sel.bin")
    res = compute_bwt(BwtOptions(input_path=inp, sa_sampling_rate=16,
                                 isa_sampling_rate=16, verbose=0))
    text = np.frombuffer(data, np.uint8).astype(np.int32)
    sa = naive_circular_sa(text)
    wanted = rng.integers(0, len(text), 40)
    got = select_ssa(res.bwt_path, wanted)
    np.testing.assert_array_equal(got, sa[wanted])


def test_device_rows_handoff(tmp_path):
    """An in-process pipeline (merge build -> checkbwt -> ssa) consumes
    the final region's device rows for the rank structure instead of
    re-uploading the .bwt; results identical to a cold reload."""
    from bwtb3m.engine import result as result_mod
    from bwtb3m.engine.ssa import compute_ssa

    rng = np.random.default_rng(3)
    codes = rng.integers(0, 4, size=5000, dtype=np.int32)
    pacp = str(tmp_path / "h.pac")
    write_pac(pacp, codes)
    res = compute_bwt(BwtOptions(input_path=pacp, input_type="pacterm",
                                 engine="merge", bwt_only=True,
                                 max_block_symbols=2048, lane_bucket=32,
                                 preisa_sampling_rate=256, verbose=0))
    assert len(result_mod._ROWS_CACHE) == 1      # hand-off registered
    text = np.concatenate([codes + 1, [0]]).astype(np.int32)
    assert check_bwt(res, text)                  # consumes the rows
    assert len(result_mod._ROWS_CACHE) == 0
    sa_path, _ = compute_ssa(res.bwt_path, 16, 16, log=None)
    from bwtb3m.io import formats as fmt
    _r, sa_vals = fmt.read_sampled_array(sa_path)
    np.testing.assert_array_equal(sa_vals, naive_circular_sa(text)[::16])


def test_select_ssa_bwtonly(tmp_path):
    """BwtSelectSSA semantics: arbitrary ranks from .bwt + .preisa ALONE
    (no sampled .sa — the reference selects mid-lcpbit on a bwtonly=1
    build, /root/reference/src/lcpbit.cpp:2417-2441)."""
    from bwtb3m.engine.ssa import select_ssa
    rng = np.random.default_rng(23)
    data = bytes(rng.integers(97, 101, size=3000, dtype=np.uint8))
    inp = _write_bytes(tmp_path, data, "selb.bin")
    res = compute_bwt(BwtOptions(input_path=inp, bwt_only=True,
                                 preisa_sampling_rate=128, verbose=0))
    assert res.sa_path is None
    text = np.frombuffer(data, np.uint8).astype(np.int32)
    sa = naive_circular_sa(text)
    wanted = np.unique(rng.integers(0, len(text), 100))
    got = select_ssa(res.bwt_path, wanted)
    np.testing.assert_array_equal(got, sa[wanted])
    # ranks that are themselves preisa samples resolve with zero steps
    pr_r, _pp, _ = res.load_preisa()
    got0 = select_ssa(res.bwt_path, pr_r[:8])
    np.testing.assert_array_equal(got0, sa[pr_r[:8]])


def test_ssa_wrap_lane_fused(tmp_path):
    """The fused SSA harvest's wrap lane (seeded at position 0, walking
    n-1, n-2, ...) must record circularly wrapped positions and shift its
    ISA sampling grid by n % isarate (round-3 regression: unwrapped uint32
    positions came out off by 2^32 - n, and wrap-lane ISA samples landed
    on the wrong grid whenever n % isarate != 0)."""
    import numpy as np
    from bwtb3m.engine import BwtOptions, compute_bwt, compute_ssa
    from bwtb3m.io import formats
    from bwtb3m.ops.doubling import suffix_array

    rng = np.random.default_rng(303)
    n = 5437  # prime: n % isarate != 0 for every rate used below
    raw = rng.choice(np.frombuffer(b"ACGT", np.uint8), size=n)
    p = tmp_path / "w.bin"
    p.write_bytes(raw.tobytes())
    # preisa rate larger than n/4 makes the wrap lane cover a long tail
    res = compute_bwt(BwtOptions(
        input_path=str(p), preisa_sampling_rate=2048, bwt_only=True,
        output_filename=str(tmp_path / "w.bwt")))
    sa_path, isa_path = compute_ssa(res.bwt_path, 16, 48)
    _r, sa_vals = formats.read_sampled_array(sa_path)
    _r2, isa_vals = formats.read_sampled_array(isa_path)
    text = raw.astype(np.int32)
    sa, isa, _ = suffix_array(text, int(text.max()) + 1)
    assert np.array_equal(sa_vals, np.asarray(sa)[::16])
    assert np.array_equal(isa_vals, np.asarray(isa)[::48])


def test_focc_cache_invalidation(tmp_path):
    # load_focc memoizes per (path, mtime, size): same file hits the
    # cache (identity), a rewritten .bwt must rebuild (the build is
    # transfer-bound, one pipeline should pay it once)
    import os
    import time as _t
    from bwtb3m.engine import BwtOptions, compute_bwt
    from bwtb3m.engine.result import BwtResult

    rng = np.random.default_rng(7)
    raw = rng.choice(np.frombuffer(b"ACGT", np.uint8), size=3000)
    p = tmp_path / "c.bin"
    p.write_bytes(raw.tobytes())
    out = str(tmp_path / "c.bwt")
    compute_bwt(BwtOptions(input_path=str(p), bwt_only=True,
                           output_filename=out))
    res = BwtResult.load(out)
    f1, m1 = res.load_focc(dense=True)
    f2, _m2 = res.load_focc(dense=True)
    assert f1 is f2, "expected cache hit for unchanged .bwt"
    # rewrite with different content: cache must miss
    raw2 = rng.choice(np.frombuffer(b"ACGT", np.uint8), size=3100)
    p.write_bytes(raw2.tobytes())
    _t.sleep(0.01)
    compute_bwt(BwtOptions(input_path=str(p), bwt_only=True,
                           output_filename=out))
    res2 = BwtResult.load(out)
    f3, _m3 = res2.load_focc(dense=True)
    assert f3 is not f1
    assert int(f3.n) == 3100 and int(f1.n) == 3000

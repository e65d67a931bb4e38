"""Regression tests for the device-rows hand-off.

Round 4 stashed the scaled engine's final device rows in a module global
and bound them to whatever ``.bwt`` the next ``compute_bwt`` wrote — so a
scaled build of text A followed by any build of text B in one process
silently handed A's rank rows to B's output, and every downstream LF walk
(checkbwt, compute_sa_device, ssa) computed garbage.  The hand-off is now
an explicit ``DeviceRowsHandle`` verified against the written file's
(n, sigma, histogram) before binding (engine/result.py).
Reference role of the cache being guarded: the freshness-checked .hwt
reuse, /root/reference/src/checkbwt.cpp:46-53.
"""

import numpy as np
import pytest

from bwtb3m.engine import (BwtOptions, check_bwt, compute_bwt,
                               compute_ssa)
from bwtb3m.engine.result import (_ROWS_CACHE, register_device_rows)
from bwtb3m.io import formats
from bwtb3m.io.pac import write_pac
from bwtb3m.ops.doubling import suffix_array
from oracle import random_string


def _scaled_pac_build(tmp_path, seed, n=6000):
    """compute_bwt through the scaled engine on a sigma=4 pac text —
    the configuration whose final region stays device-resident and
    triggers the rows hand-off (merge_scaled.py, sigma <= 8)."""
    codes = random_string(n, 4, seed=seed)
    p = str(tmp_path / ("g%d.pac" % seed))
    write_pac(p, codes)
    res = compute_bwt(BwtOptions(
        input_path=p, input_type="pac", engine="merge",
        max_block_symbols=2048, preisa_sampling_rate=512,
        bwt_only=True, verbose=0))
    return res, codes


def test_scaled_then_unrelated_build_is_uncorrupted(tmp_path):
    # Build A (scaled, rows hand-off registered for A's .bwt) ...
    res_a, codes_a = _scaled_pac_build(tmp_path, seed=21)
    assert len(_ROWS_CACHE) == 1  # hand-off is pending, keyed to A

    # ... then build B with the doubling engine on a DIFFERENT text.
    rng = np.random.default_rng(5)
    raw = bytes(rng.integers(97, 102, size=3000, dtype=np.uint8))
    pb = tmp_path / "b.bin"
    pb.write_bytes(raw)
    res_b = compute_bwt(BwtOptions(
        input_path=str(pb), input_type="bytestream",
        preisa_sampling_rate=256, verbose=0))

    # B's outputs must be untouched by A's pending rows: checkbwt walks
    # the full text, and the sampled SA must match the oracle.
    text_b = np.frombuffer(raw, np.uint8).astype(np.int32)
    assert check_bwt(res_b, text_b)
    sa, _isa, _bwt = suffix_array(text_b, int(text_b.max()) + 1)
    rate, sa_vals = formats.read_sampled_array(res_b.sa_path)
    np.testing.assert_array_equal(sa_vals, np.asarray(sa)[::rate])

    # A's own pipeline still verifies (its hand-off rows, if consumed,
    # must describe A)
    assert check_bwt(res_a, codes_a.astype(np.int32))


def test_two_scaled_builds_each_verify(tmp_path):
    res_a, codes_a = _scaled_pac_build(tmp_path, seed=31)
    res_b, codes_b = _scaled_pac_build(tmp_path, seed=32, n=5000)
    # the second build's hand-off replaced the first (hold at most one);
    # both outputs verify, and B's ssa derives from B's bwt alone
    assert check_bwt(res_b, codes_b.astype(np.int32))
    assert check_bwt(res_a, codes_a.astype(np.int32))
    sa_path, _ = compute_ssa(res_b.bwt_path, 32, 64)
    sa, _isa, _bwt = suffix_array(codes_b.astype(np.int32), 4)
    _r, sa_vals = formats.read_sampled_array(sa_path)
    np.testing.assert_array_equal(sa_vals, np.asarray(sa)[::32])


def test_handoff_with_alphabet_compaction(tmp_path):
    # bytestream ACGT: the file's sigma is 256 but only 4 symbols occur;
    # the engine rank-compacts to dense nibble rows and hands them off
    # WITH the symmap (engine/api.py alphabet compaction) — checkbwt and
    # ssa must consume the hit and still verify against the raw text
    rng = np.random.default_rng(51)
    raw = rng.choice(np.frombuffer(b"ACGT", np.uint8), size=6000)
    p = tmp_path / "t.bin"
    p.write_bytes(raw.tobytes())
    res = compute_bwt(BwtOptions(
        input_path=str(p), input_type="bytestream", engine="merge",
        max_block_symbols=2048, preisa_sampling_rate=512,
        bwt_only=True, verbose=0))
    assert len(_ROWS_CACHE) == 1   # dense rows + symmap registered
    text = raw.astype(np.int32)
    assert check_bwt(res, text)    # consumes the symmap'd rows hit
    sa_path, _ = compute_ssa(res.bwt_path, 32, 64)
    sa, _isa, _b = suffix_array(text, int(text.max()) + 1)
    _r, sa_vals = formats.read_sampled_array(sa_path)
    np.testing.assert_array_equal(sa_vals, np.asarray(sa)[::32])


def test_register_refuses_identity_mismatch(tmp_path):
    from bwtb3m.engine.merge_scaled import DeviceRowsHandle
    res, codes = _scaled_pac_build(tmp_path, seed=41, n=3000)
    hist = np.bincount(codes, minlength=4).astype(np.int64)
    # wrong n
    h = DeviceRowsHandle(rows=object(), n=len(codes) + 1, sigma=4, hist=hist)
    with pytest.raises(ValueError):
        register_device_rows(res.bwt_path, h, len(codes), 4, hist)
    # wrong histogram
    bad = hist.copy()
    bad[0] += 1
    bad[1] -= 1
    h = DeviceRowsHandle(rows=object(), n=len(codes), sigma=4, hist=bad)
    with pytest.raises(ValueError):
        register_device_rows(res.bwt_path, h, len(codes), 4, hist)

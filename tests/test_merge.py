"""Blockwise gap-merge engine vs the single-block doubling engine.

The reference "fakes scale" by forcing small mem= targets so tiny inputs
exercise many blocks and merge levels (SURVEY.md section 4 note); here we
force tiny max_block_symbols and assert bit-equality against engine A.
"""

import numpy as np
import pytest

from bwtb3m.engine.merge import blockwise_bwt
from bwtb3m.engine.options import BwtOptions
from bwtb3m.ops.doubling import suffix_array
from bwtb3m.ops.gap import compute_gt0
from bwtb3m.ops.windowsort import block_suffix_order
from bwtb3m.util.log import VerboseLog
from oracle import naive_circular_sa, random_string


def _opts(tmpdir, max_block, large_lcp=64):
    return BwtOptions(input_path=str(tmpdir / "x"), output_filename=str(tmpdir / "x.bwt"),
                      max_block_symbols=max_block, large_lcp_thres=large_lcp)


def _check(tmp_path, text, max_block, sigma=None, segments=4, anchor=32):
    text = np.asarray(text, dtype=np.int32)
    if sigma is None:
        sigma = int(text.max()) + 1
    opts = _opts(tmp_path, max_block)
    sa, isa, bwt = suffix_array(text, sigma)
    for mode in ("tree", "fold"):
        sa_m, isa_m, bwt_m = blockwise_bwt(
            text, sigma, opts, VerboseLog(0),
            num_segments=segments, anchor_lookback=anchor, merge_mode=mode)
        np.testing.assert_array_equal(sa_m, sa, err_msg="mode=" + mode)
        np.testing.assert_array_equal(isa_m, isa, err_msg="mode=" + mode)
        np.testing.assert_array_equal(bwt_m, bwt, err_msg="mode=" + mode)


def test_gt0():
    text = np.array([ord(c) for c in "banana"], dtype=np.int32)
    sa = naive_circular_sa(text)
    isa = np.zeros(len(sa), np.int64)
    isa[sa] = np.arange(len(sa))
    gt0 = compute_gt0(text)
    # gt0[x]=1 iff rot_0 strictly smaller than rot_x (no equal rotations
    # in "banana", so this matches the ISA comparison)
    expect = (isa[0] < isa).astype(np.uint8)
    expect[0] = 0
    np.testing.assert_array_equal(gt0, expect)


def test_gt0_periodic():
    text = np.tile([1, 0], 4).astype(np.int32)  # rot_0 == rot_2 == ...
    gt0 = compute_gt0(text)
    # strictly-smaller: equal rotations (even x) give 0; odd rotations
    # start with 0 < 1 so rot_0 is larger -> also 0
    np.testing.assert_array_equal(gt0, [0, 0, 0, 0, 0, 0, 0, 0])


def test_window_sort_resolved():
    text = random_string(64, 4, seed=0)
    # whole text as one window with block = all: plain suffix sort
    lo_order, hi_order, resolved = block_suffix_order(
        np.concatenate([text, text[:32]]), 64, 4)
    assert resolved
    np.testing.assert_array_equal(lo_order, hi_order)


@pytest.mark.parametrize("n,blocks", [(64, 2), (100, 3), (256, 4), (500, 5)])
def test_blockwise_random(tmp_path, n, blocks):
    text = random_string(n, 4, seed=n * 31 + blocks)
    _check(tmp_path, text, max_block=(n + blocks - 1) // blocks)


def test_blockwise_bytes(tmp_path):
    text = random_string(300, 200, seed=5)
    _check(tmp_path, text, max_block=90)


def test_blockwise_small_alphabet(tmp_path):
    text = random_string(400, 2, seed=6)
    _check(tmp_path, text, max_block=128)


def test_blockwise_repetitive(tmp_path):
    # long runs + repeats spanning block boundaries force lookahead
    # extension and anchor work
    base = np.array([0, 0, 0, 1, 0, 0, 0, 1, 2], np.int32)
    text = np.concatenate([np.tile(base, 30), [3]]).astype(np.int32)
    _check(tmp_path, text, max_block=64, segments=3, anchor=8)


def test_blockwise_periodic_text(tmp_path):
    text = np.tile([0, 1, 1], 40).astype(np.int32)  # fully periodic
    _check(tmp_path, text, max_block=32)


def test_blockwise_single_segment(tmp_path):
    text = random_string(200, 4, seed=9)
    _check(tmp_path, text, max_block=64, segments=1)


def test_blockwise_many_segments(tmp_path):
    text = random_string(512, 4, seed=10)
    _check(tmp_path, text, max_block=200, segments=16, anchor=16)


@pytest.mark.slow
def test_engine_dispatches_to_blockwise(tmp_path):
    from bwtb3m.engine import BwtOptions as BO, check_bwt, compute_bwt
    data = bytes(random_string(3000, 4, seed=77).astype(np.uint8) + 97)
    inp = tmp_path / "big.bin"
    inp.write_bytes(data)
    res = compute_bwt(BO(input_path=str(inp), max_block_symbols=1000,
                         preisa_sampling_rate=512, verbose=0))
    text = np.frombuffer(data, np.uint8).astype(np.int32)
    from bwtb3m.io.rl import rl_decode
    _sa, _isa, bwt = suffix_array(text, 256)
    np.testing.assert_array_equal(rl_decode(res.bwt_path), bwt)
    assert check_bwt(res, text)

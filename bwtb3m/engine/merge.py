"""Blockwise BWT construction with gap-array merging — the LEGACY
full-SA variant (round 1). The production scale path is
``engine/merge_scaled.py``: regions carry only BWT + samples, chains run
fully on device, and host memory stays O(n) bytes; this module keeps the
simpler full-SA/ISA construction for small texts, wide alphabets
(sigma > 16) and as a second implementation for cross-engine fuzzing.

Equivalent of the reference's balanced block merge (``BwtMergeSort``
phases 2-3, SURVEY.md section 3.1).

The text lives in host RAM (the analog of the reference's disk); device
HBM holds only one block's sort window or one pair's rank structure at a
time. Blocks are sorted independently on device (ops/windowsort.py), then
merged up a **balanced binary tree** (the reference's namesake design):
each pair merge (left [s,m), right [m,e)) computes the gap array with
anchored, batched backward-search chains against the right side's occ
table (ops/gap.py) and interleaves the two halves on host. The boundary
gt-vectors the reference propagates block-to-block are instead computed
lazily on device per merge (``gt_against``), only for the positions the
chains actually visit.

``merge_mode="fold"`` folds blocks right-to-left into one growing region
instead (fewer, longer chains; same results).

Outputs are bit-identical to the single-block doubling engine (tested on
the virtual mesh suite): same rotation order, same position tie-breaks.
"""

from __future__ import annotations

import dataclasses
import math
import os
from typing import List, Optional, Tuple

import numpy as np

from ..ops.gap import GapChainRunner
from ..ops.rank import build_occ
from ..ops.windowsort import block_suffix_order
from ..util.log import VerboseLog
from .options import BwtOptions


@dataclasses.dataclass
class _Region:
    s: int
    e: int
    sa: np.ndarray    # positions in rotation order
    bwt: np.ndarray   # text[(sa-1) mod n]


def _plan_blocks(n: int, max_block: int):
    """Contiguous blocks of ~equal size, each <= max_block."""
    nb = max(1, math.ceil(n / max_block))
    bounds = np.linspace(0, n, nb + 1).astype(np.int64)
    return [(int(bounds[i]), int(bounds[i + 1])) for i in range(nb)]


def _sort_block(text: np.ndarray, s: int, e: int, sigma: int,
                lookahead: int, log: VerboseLog) -> _Region:
    """Rotation order of positions [s, e), via windowed doubling with
    automatic lookahead extension."""
    n = len(text)
    block_len = e - s
    la = min(lookahead, n)
    while True:
        W = min(block_len + la, block_len + n)
        idx = (s + np.arange(W)) % n
        lo_order, hi_order, resolved = block_suffix_order(text[idx], block_len, sigma)
        if resolved:
            sa = (lo_order + s).astype(np.int64)
            break
        if la >= n:
            # every block suffix saw the full rotation: remaining ties are
            # equal rotations, ordered by position = the pad_high order
            sa = (hi_order + s).astype(np.int64)
            break
        la = min(la * 4, n)
        log.v("block [%d,%d): lookahead extended to %d" % (s, e, la))
    return _Region(s, e, sa, text[(sa - 1) % n])


def _merge_pair(text: np.ndarray, sigma: int, left: _Region, right: _Region,
                log: VerboseLog, num_segments: int, anchor_lookback: int
                ) -> _Region:
    n = len(text)
    s, m, e = left.s, left.e, right.e
    assert right.s == m
    block_len = m - s

    occt = build_occ(right.bwt, sigma)
    isa_m = int(np.flatnonzero(right.sa == m)[0])
    runner = GapChainRunner(occt, text, m, e, isa_m)

    T = max(1, min(num_segments, block_len // 64 or 1))
    seg_bounds = np.linspace(s, m, T + 1).astype(np.int64)
    starts = seg_bounds[1:] - 1
    lens = seg_bounds[1:] - seg_bounds[:-1]
    seeds = np.zeros(T, dtype=np.int64)
    seeds[T - 1] = isa_m
    if T > 1:
        lb = anchor_lookback
        while True:
            vals, ok = runner.anchor(starts[: T - 1], min(lb, n))
            if ok.all():
                seeds[: T - 1] = vals
                break
            if lb >= n:
                log.w("anchors unresolved at full lookback; running one chain")
                T = 1
                starts = np.array([m - 1], dtype=np.int64)
                lens = np.array([block_len], dtype=np.int64)
                seeds = np.array([isa_m], dtype=np.int64)
                break
            lb = min(lb * 4, n)
            log.v("anchor lookback extended to %d" % lb)

    gap, _final = runner.run_chains(starts, seeds, lens)
    assert gap.sum() == block_len, (gap.sum(), block_len)

    # host interleave guided by the gap histogram
    Mlen = len(right.sa)
    cnt_le = np.cumsum(gap)
    merged_len = Mlen + block_len
    sa_new = np.empty(merged_len, dtype=np.int64)
    bwt_new = np.empty(merged_len, dtype=right.bwt.dtype)
    m_dest = np.arange(Mlen) + cnt_le[:Mlen]
    sa_new[m_dest] = right.sa
    bwt_new[m_dest] = right.bwt
    r_per_entry = np.repeat(np.arange(Mlen + 1), gap)
    b_dest = r_per_entry + np.arange(block_len)
    sa_new[b_dest] = left.sa
    bwt_new[b_dest] = left.bwt
    return _Region(s, e, sa_new, bwt_new)


def blockwise_bwt(symbols: np.ndarray, sigma: int, options: BwtOptions,
                  log: Optional[VerboseLog] = None,
                  num_segments: int = 4096,
                  anchor_lookback: Optional[int] = None,
                  merge_mode: str = "tree",
                  ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Returns (sa, isa, bwt) identical to ops.doubling.suffix_array."""
    log = log or VerboseLog(1)
    text = np.asarray(symbols, dtype=np.int32)
    n = len(text)
    return _blockwise_bwt_impl(text, sigma, options, log,
                               num_segments, anchor_lookback, merge_mode)


def _blockwise_bwt_impl(text, sigma, options, log, num_segments,
                        anchor_lookback, merge_mode):
    n = len(text)
    blocks = _plan_blocks(n, options.max_block_symbols)
    lookahead = max(1024, options.large_lcp_thres)
    if anchor_lookback is None:
        # start short — anchors only need enough context to make their
        # prefix unique within the right region (~log_sigma|M| symbols for
        # non-repetitive text); the x4 extension loop handles repeats up
        # to large_lcp_thres and beyond
        anchor_lookback = 256
    log.v("blockwise engine (%s): %d blocks, lookahead=%d"
          % (merge_mode, len(blocks), lookahead))

    regions: List[_Region] = [
        _sort_block(text, s, e, sigma, lookahead, log) for s, e in blocks
    ]

    stop_file = options.output_filename + ".stop"

    def check_stop(done, total):
        if os.path.exists(stop_file):
            # manual kill switch between merges — the analog of the
            # reference's "loopscomplete" escape hatch (lcpbit.cpp:965)
            raise RuntimeError(
                "stop requested via %s after %d/%d merges"
                % (stop_file, done, total))

    total = len(regions) - 1
    done = 0
    if merge_mode == "fold":
        M = regions[-1]
        for left in reversed(regions[:-1]):
            check_stop(done, total)
            M = _merge_pair(text, sigma, left, M, log,
                            num_segments, anchor_lookback)
            done += 1
            log.v("merged [%d,%d): |M|=%d" % (M.s, M.e, len(M.sa)))
        final = M
    else:  # balanced tree
        level = regions
        while len(level) > 1:
            nxt: List[_Region] = []
            i = 0
            while i + 1 < len(level):
                check_stop(done, total)
                merged = _merge_pair(text, sigma, level[i], level[i + 1],
                                     log, num_segments, anchor_lookback)
                done += 1
                log.v("merged [%d,%d): |M|=%d" % (merged.s, merged.e,
                                                  len(merged.sa)))
                nxt.append(merged)
                i += 2
            if i < len(level):
                nxt.append(level[i])
            level = nxt
        final = level[0]

    sa = final.sa
    isa = np.zeros(n, dtype=np.int64)
    isa[sa] = np.arange(n, dtype=np.int64)
    return sa, isa, final.bwt.astype(np.int32)

"""Gap-array computation — the merge engine's dominant kernel.

Reference semantics (SURVEY.md section 3.1 phase 3, arXiv:1604.06687): to
merge a left block [s, m) into the merged-so-far right part M = [m, n),
compute for every p in [s, m) its rank R(p) among M's rotations by walking
backwards through the left block, one rank query on M's BWT per step — HOT
LOOP #2, the kernel the north star requires at memory-bandwidth limit.

Exact recurrence for the circular rotation order with position tie-break
(derived for this rebuild; ``c = text[p]``):

    R(p) = cntM_lt[c]                                (M rotations with
                                                      smaller first symbol)
         + rank_{BWT_M}(c, R(p+1))                   (partial-BWT rank)
         - [ISA_M(m) < R(p+1)] * [text[m-1] = c]     (the BWT_M row whose
                                                      predecessor is outside
                                                      M must not be counted)
         + [text[n-1] = c] * gt0[p+1]                (wrap row: rotation 0
                                                      prepended by text[n-1])

with R(m) = ISA_M(m), and gt0[x] = 1 iff rotation 0 is STRICTLY smaller
than rotation x (the tie-break compares original positions q = n-1 > p, so
equal rotations never count in the wrap term).

Device design: the chain is sequential in p but *batched across segments* —
the left block is split into T segments, segment starts are anchored by an
interval-contraction run of the same recurrence (the map R -> f_p(R) is
monotone, so iterating it on the bounds [0, |M|] contracts to the exact
rank once the segment's lookback distinguishes it — the parallel-split
idea behind the reference's ``largelcpthres`` guard, bwtb3m.cpp:55), after
which all T chains step simultaneously: every step is one batched occ
rank query (thousands of lanes — the bwttestdecodespeed.cpp:67-97 lesson
at device scale).
"""

from __future__ import annotations

from functools import partial
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from .rank import OccTable, _select_col, rank_batch


@partial(jax.jit, static_argnums=(7,))
def _chain_steps(occt: OccTable, c_first: jnp.ndarray, text_chunk: jnp.ndarray,
                 gt0_chunk: jnp.ndarray, r: jnp.ndarray, active_len: jnp.ndarray,
                 consts: jnp.ndarray, chunk: int,
                 gap: jnp.ndarray) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Run `chunk` chain steps for all lanes.

    text_chunk[j, i] = text[start_j - i] (the symbol consumed at step i),
    gt0_chunk[j, i]  = gt0[start_j - i + 1] (wrap flag for that step).
    consts = [isa_m, sym_before_m, sym_last, gap_size] int32.
    Lane j executes only its first active_len[j] steps. Each executed step
    first records the *new* R(p) into the gap histogram.
    """
    isa_m, sym_before_m, sym_last, gap_size = (
        consts[0], consts[1], consts[2], consts[3])

    def body(i, carry):
        r, gap = carry
        c = text_chunk[:, i]
        g0 = gt0_chunk[:, i]
        active = i < active_len
        # mask-select instead of an element gather
        cnt_lt = _select_col(
            jnp.broadcast_to(c_first[None, :], (c.shape[0], c_first.shape[0])), c)
        rk = rank_batch(occt, c, r)
        corr = jnp.logical_and(isa_m < r, c == sym_before_m).astype(jnp.int32)
        wrap = jnp.logical_and(c == sym_last, g0 == 1).astype(jnp.int32)
        r_new = cnt_lt + rk - corr + wrap
        r = jnp.where(active, r_new, r)
        idx = jnp.where(active, r_new, gap_size + 1)
        gap = gap.at[idx].add(1, mode="drop")
        return (r, gap)

    r, gap = lax.fori_loop(0, chunk, body, (r, gap))
    return r, gap


@partial(jax.jit, static_argnums=(7,))
def _anchor_steps(occt: OccTable, c_first: jnp.ndarray, text_chunk: jnp.ndarray,
                  gt0_chunk: jnp.ndarray, bounds: jnp.ndarray,
                  active_from: jnp.ndarray, consts: jnp.ndarray,
                  chunk: int) -> jnp.ndarray:
    """Interval-contraction anchoring: iterate the monotone chain map on
    lower/upper bounds simultaneously. bounds: int32 [T, 2]; lane j only
    starts stepping at global step index active_from[j] (per-lane lookback
    clamps)."""
    isa_m, sym_before_m, sym_last, _ = (
        consts[0], consts[1], consts[2], consts[3])

    def body(i, carry):
        bounds, step0 = carry
        c = text_chunk[:, i]
        g0 = gt0_chunk[:, i]
        active = (step0 + i) >= active_from
        out = []
        cnt_lt = _select_col(
            jnp.broadcast_to(c_first[None, :], (c.shape[0], c_first.shape[0])), c)
        for k in (0, 1):
            r = bounds[:, k]
            rk = rank_batch(occt, c, r)
            corr = jnp.logical_and(isa_m < r, c == sym_before_m).astype(jnp.int32)
            wrap = jnp.logical_and(c == sym_last, g0 == 1).astype(jnp.int32)
            nr = cnt_lt + rk - corr + wrap
            out.append(jnp.where(active, nr, r))
        return (jnp.stack(out, axis=1), step0)

    bounds, _ = lax.fori_loop(0, chunk, body, (bounds, active_from[0] * 0))
    return bounds


class GapChainRunner:
    """Host orchestration of the anchored, chunked gap computation.

    Generalized to an arbitrary right region M = [m, e) (e = n for the
    rightmost region, where rot_e = rot_0): the recurrence's boundary term
    then uses text[e-1] and gt_e[x] = [rot_e strictly < rot_x], computed
    lazily on device for exactly the positions the chains visit
    (``gt_against``)."""

    # per-chunk host->device staging budget (text + gt arrays, bytes)
    TRANSFER_BUDGET = 64 << 20

    def __init__(self, occt: OccTable, text: np.ndarray, m: int, e: int,
                 isa_m: int, chunk: int = 0):
        self.occt = occt
        self.text = text
        self.n = len(text)
        self.m = m
        self.e = e
        self.isa_m = isa_m
        self.chunk = chunk  # 0 = adaptive per lane count (see _auto_chunk)
        self.gap_size = occt.n  # |M| == e - m
        assert self.gap_size == e - m
        # lazy gt_e coverage
        self._gt = np.zeros(self.n, dtype=np.uint8)
        self._gt_known = np.zeros(self.n, dtype=bool)
        # cumulative first-symbol histogram of M's own range text[m:e):
        # c_first[c] = number of M rotations starting with a symbol < c.
        # (NOT occt.C: the occ table is over BWT_M, whose chars are the
        # rotations' predecessors, including one from outside M.)
        sigma = occt.sigma
        first_hist = np.bincount(text[m:e], minlength=sigma).astype(np.int64)
        self.c_first = jnp.asarray(
            np.concatenate([[0], np.cumsum(first_hist)]).astype(np.int32))
        self.consts = jnp.asarray(np.array([
            isa_m,
            text[(m - 1) % self.n],
            text[(e - 1) % self.n],
            self.gap_size,
        ], dtype=np.int32))

    def _auto_chunk(self, T: int) -> int:
        if self.chunk:
            return self.chunk
        per_step_bytes = max(1, T) * 8  # int32 text + int32 gt per lane
        return max(1024, min(1 << 14, self.TRANSFER_BUDGET // per_step_bytes))

    def _gt_at(self, pos: np.ndarray) -> np.ndarray:
        missing = np.unique(pos[~self._gt_known[pos]])
        if len(missing):
            self._gt[missing] = gt_against(self.text, self.e % self.n, missing)
            self._gt_known[missing] = True
        return self._gt[pos]

    def _chunks(self, starts: np.ndarray, lens: np.ndarray, offset: int,
                count: int):
        """Host-side gather of text/gt for `count` steps beginning at
        per-lane step `offset`. Step i of lane j consumes position
        starts[j] - offset - i."""
        T = len(starts)
        steps = offset + np.arange(count)
        pos = (starts[:, None] - steps[None, :]) % self.n  # [T, count]
        return (jnp.asarray(self.text[pos].astype(np.int32)),
                jnp.asarray(self._gt_at((pos + 1) % self.n).astype(np.int32)))

    def run_chains(self, starts: np.ndarray, r0: np.ndarray,
                   lens: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """Walk lane j from position starts[j] (seeded with R(starts[j]+1)
        = r0[j]) for lens[j] steps, recording each new R into the gap
        histogram. Returns (gap histogram int64 [gap_size+1], final ranks).

        Lane j's step i computes R(starts[j] - i).
        """
        T = len(starts)
        max_len = int(lens.max()) if T else 0
        chunk = self._auto_chunk(T)
        gap = jnp.zeros(self.gap_size + 2, jnp.int32)  # +slack for drop idx
        r = jnp.asarray(r0.astype(np.int32))
        done = 0
        while done < max_len:
            count = min(chunk, max_len - done)
            text_chunk, gt0_chunk = self._chunks(starts, lens, done, count)
            active = jnp.asarray(
                np.minimum(np.maximum(lens - done, 0), count).astype(np.int32))
            r, gap = _chain_steps(self.occt, self.c_first, text_chunk,
                                  gt0_chunk, r, active, self.consts, count, gap)
            done += count
        gap_np = np.asarray(gap[: self.gap_size + 1], dtype=np.int64)
        return gap_np, np.asarray(r, dtype=np.int64)

    def anchor(self, starts: np.ndarray, lookback: int) -> Tuple[np.ndarray, np.ndarray]:
        """Compute R(start_j + 1) for each anchor by interval contraction
        over up to `lookback` steps ending at position start_j + 1.
        Per-lane lookback is clamped so no anchor position reaches e (the
        strict-gt wrap term's tie handling requires p <= e-1). Returns
        (ranks, resolved_mask)."""
        T = len(starts)
        lb = np.minimum(lookback, (self.e - 2) - starts)  # positions <= e-1
        lb = np.maximum(lb, 1)
        maxlb = int(lb.max())
        bounds = np.zeros((T, 2), dtype=np.int32)
        bounds[:, 1] = self.gap_size
        b = jnp.asarray(bounds)
        # lane j consumes positions (start_j + lb_j) down to (start_j + 1):
        # it runs the final lb_j of the maxlb global steps
        anchor_starts = starts + maxlb
        active_from = jnp.asarray((maxlb - lb).astype(np.int32))
        chunk = self._auto_chunk(T)
        done = 0
        while done < maxlb:
            count = min(chunk, maxlb - done)
            text_chunk, gt0_chunk = self._chunks(anchor_starts, None, done, count)
            b = _anchor_steps(self.occt, self.c_first, text_chunk, gt0_chunk,
                              b, active_from - done, self.consts, count)
            done += count
        b_np = np.asarray(b, dtype=np.int64)
        return b_np[:, 0], b_np[:, 0] == b_np[:, 1]


def compute_gt0(text: np.ndarray) -> np.ndarray:
    """gt0[x] = 1 iff rotation 0 is STRICTLY smaller than rotation x.
    O(n) host pass via the Z-algorithm on text+text.

    Strictness matters: the wrap term counts q = n-1 (whose successor
    rotation is rot_0), and the position tie-break compares the *original*
    positions q = n-1 > p, so equal rotations must not be counted — using
    position 0's tie-break after the wrap would be wrong (it flips the
    order). This is the global analog of the reference's gt-bitvector
    machinery (SURVEY.md hard-part 3).
    """
    text = np.asarray(text)
    n = len(text)
    if n == 0:
        return np.zeros(0, np.uint8)
    from .. import native
    nat = native.gt0(text)
    if nat is not None:
        return nat
    s = np.concatenate([text, text])
    # Z-array of s (classic algorithm), z[x] capped at n
    z = np.zeros(2 * n, dtype=np.int64)
    l, r = 0, 0
    for x in range(1, 2 * n):
        zx = 0
        if x < r:
            zx = min(r - x, z[x - l])
        while x + zx < 2 * n and zx < n and s[zx] == s[x + zx]:
            zx += 1
        if x + zx > r:
            l, r = x, x + zx
        z[x] = min(zx, n)
    gt0 = np.zeros(n, dtype=np.uint8)
    for x in range(1, n):
        lcp = z[x]
        if lcp >= n:
            gt0[x] = 0  # equal rotations: strictly-smaller is false
        else:
            # rot_0 < rot_x iff text[lcp] < text[(x+lcp) mod n]
            gt0[x] = 1 if text[lcp] < text[(x + lcp) % n] else 0
    return gt0


# --------------------------------------------------------------------------
# boundary gt vectors for inner merge-tree pairs
# --------------------------------------------------------------------------

@partial(jax.jit, static_argnums=(3,))
def _gt_compare_chunk(text: jnp.ndarray, a_off: jnp.ndarray, b_off: jnp.ndarray,
                      chunk: int, lcp: jnp.ndarray, state: jnp.ndarray):
    """Advance per-lane rotation comparisons by up to `chunk` symbols.

    state: -1 undecided, 0 rot_a >= rot_b decided-greater-or-equal... see
    gt_against. Returns updated (lcp, state) where state in {-1, 0, 1}:
    1 = rot_a < rot_b, 0 = rot_a > rot_b, -1 = still equal so far.
    """
    n = text.shape[0]
    j = lax.broadcasted_iota(jnp.int32, (a_off.shape[0], chunk), 1)
    ai = (a_off[:, None] + lcp[:, None] + j) % n
    bi = (b_off[:, None] + lcp[:, None] + j) % n
    av = jnp.take(text, ai)
    bv = jnp.take(text, bi)
    neq = av != bv
    any_neq = jnp.any(neq, axis=1)
    first = jnp.argmax(neq, axis=1).astype(jnp.int32)
    a_first = jnp.take_along_axis(av, first[:, None], axis=1)[:, 0]
    b_first = jnp.take_along_axis(bv, first[:, None], axis=1)[:, 0]
    newly = jnp.logical_and(state == -1, any_neq)
    state = jnp.where(newly, (a_first < b_first).astype(jnp.int32), state)
    lcp = jnp.where(state == -1, lcp + chunk, lcp)
    return lcp, state


def gt_against(text: np.ndarray, e: int, xs: np.ndarray,
               chunk: int = 128, batch: int = 1 << 18) -> np.ndarray:
    """gt[x] = 1 iff rotation e is STRICTLY smaller than rotation x, for
    each x in xs — the boundary oracle for inner merge-tree pairs (the
    generalization of gt0; the reference's gt-bitvector role, SURVEY.md
    hard-part 3). Vectorized chunked comparison on device, processed in
    bounded lane batches (the compare scratch is [batch, chunk]); equal
    rotations (lcp reaches n) yield 0 (strictness, as in compute_gt0)."""
    n = len(text)
    total = len(xs)
    if total == 0:
        return np.zeros(0, np.uint8)
    text_dev = jnp.asarray(np.asarray(text, dtype=np.int32))
    out = np.zeros(total, np.uint8)
    for base in range(0, total, batch):
        part = np.asarray(xs[base : base + batch], dtype=np.int32) % n
        B = len(part)
        a_off = jnp.full((B,), int(e) % n, jnp.int32)
        b_off = jnp.asarray(part)
        lcp = jnp.zeros(B, jnp.int32)
        state = jnp.full(B, -1, jnp.int32)
        done = 0
        while done < n:
            lcp, state = _gt_compare_chunk(text_dev, a_off, b_off, chunk,
                                           lcp, state)
            done += chunk
            if not bool(np.any(np.asarray(state) == -1)):
                break
        out[base : base + B] = (np.asarray(state) == 1).astype(np.uint8)
    return out

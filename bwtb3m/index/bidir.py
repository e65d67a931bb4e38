"""True bidirectional FM index — synchronized forward/reverse intervals.

Role of libmaus2's ``BidirectionalDnaIndexImpCompactHuffmanWaveletTree``
(/root/reference/src/allHamDna.cpp:59): one index over the text and one
over its reverse, kept in lockstep so a match window can be extended by a
symbol on EITHER side in O(1) rank work (Lam et al. 2009 2BWT / Li 2012
FMD design).  Round-2 shipped per-strand backward search only (same hit
set for Hamming all-mapping); this structure adds
the synchronized-interval machinery needed for seed-and-extend.

State per pattern window w: (lo, lo_rev, size) with
[lo, lo+size) = rotations of T prefixed by w (rank space of BWT(T)) and
[lo_rev, lo_rev+size) = rotations of reverse(T) prefixed by reverse(w).

extend_left(a):  w -> a·w   via the FORWARD index:
    lo'     = C[a] + occ_a(lo)
    size'   = occ_a(lo+size) - occ_a(lo)
    lo_rev' = lo_rev + sum_{b < a} (occ_b(lo+size) - occ_b(lo))
extend_right(a): w -> w·a   symmetric through the reverse index.

The smaller-symbol prefix sums come from ``rank_all_batch_bp`` — ALL
sigma ranks from the one gathered row — so either extension costs two
row gathers per batch, matching the single-direction step.

Batched device-side: every operation takes [B] interval arrays; thousands
of windows extend per dispatch (the bwttestdecodespeed lesson).
"""

from __future__ import annotations

from typing import Tuple

import jax.numpy as jnp
import numpy as np

from ..ops.focc_bp import FusedOccBP, build_focc_bp, rank_all_batch_bp


class BidirectionalFMIndex:
    def __init__(self, bwt_fwd: np.ndarray, bwt_rev: np.ndarray,
                 sigma: int):
        if sigma > 8:
            raise ValueError("bidirectional index uses the bit-plane "
                             "rank rows (sigma <= 8)")
        self.sigma = int(sigma)
        self.n = len(bwt_fwd)
        assert len(bwt_rev) == self.n
        self.fwd = build_focc_bp(jnp.asarray(
            np.asarray(bwt_fwd, np.uint8).astype(np.int32)), sigma)
        self.rev = build_focc_bp(jnp.asarray(
            np.asarray(bwt_rev, np.uint8).astype(np.int32)), sigma)

    @classmethod
    def from_text(cls, text: np.ndarray, sigma: int
                  ) -> "BidirectionalFMIndex":
        """Build both BWTs with the device engine (small/medium texts;
        at scale feed precomputed BWTs from two engine runs)."""
        from ..ops.doubling import suffix_array

        text = np.asarray(text, dtype=np.int32)
        _sa, _isa, bwt_f = suffix_array(text, sigma)
        _sa2, _isa2, bwt_r = suffix_array(text[::-1].copy(), sigma)
        return cls(np.asarray(bwt_f, np.uint8), np.asarray(bwt_r, np.uint8),
                   sigma)

    # ------------------------------------------------------------- state

    def whole(self, batch: int) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
        """[B] interval state covering the whole rank space (empty w)."""
        z = jnp.zeros(batch, jnp.uint32)
        return z, z.copy(), jnp.full(batch, self.n, jnp.uint32)

    # -------------------------------------------------------- extensions

    def _extend(self, focc: FusedOccBP, a, lo, lo_o, size):
        """Shared extension arithmetic through `focc` (fwd for
        extend_left, rev for extend_right)."""
        a = jnp.asarray(a).astype(jnp.int32)
        ranks_l = rank_all_batch_bp(focc, lo)                  # [B, sigma]
        ranks_u = rank_all_batch_bp(focc, lo + size)
        win = ranks_u - ranks_l                                # counts per b
        cols = jnp.arange(self.sigma, dtype=jnp.int32)[None, :]
        sel = cols == a[:, None]
        ra_l = jnp.sum(jnp.where(sel, ranks_l, jnp.uint32(0)), axis=1)
        cnt = jnp.sum(jnp.where(sel, win, jnp.uint32(0)), axis=1)
        smaller = jnp.sum(jnp.where(cols < a[:, None], win, jnp.uint32(0)),
                          axis=1)
        Ca = jnp.sum(jnp.where(sel, focc.C[None, : self.sigma],
                               jnp.uint32(0)), axis=1)
        lo2 = Ca + ra_l
        lo_o2 = lo_o + smaller
        return lo2, lo_o2, cnt

    def extend_left(self, a, lo, lo_rev, size):
        """w -> a·w; returns (lo', lo_rev', size') (size' 0 = no match)."""
        return self._extend(self.fwd, a, lo, lo_rev, size)

    def extend_right(self, a, lo, lo_rev, size):
        """w -> w·a: extend reverse(w) on its left through the reverse
        index; the roles of the two interval words swap."""
        lo_rev2, lo2, cnt = self._extend(self.rev, a, lo_rev, lo, size)
        return lo2, lo_rev2, cnt

    # ----------------------------------------------------------- queries

    def count(self, pattern: np.ndarray, from_right: bool = False) -> int:
        """Occurrences of `pattern` as a rotation prefix window,
        extending symbol-by-symbol from the chosen side."""
        p = np.asarray(pattern, dtype=np.int64)
        lo, lo_rev, size = self.whole(1)
        order = p[::-1] if not from_right else p
        for c in order:
            if from_right:
                lo, lo_rev, size = self.extend_right(
                    jnp.asarray([int(c)]), lo, lo_rev, size)
            else:
                lo, lo_rev, size = self.extend_left(
                    jnp.asarray([int(c)]), lo, lo_rev, size)
        return int(np.asarray(size)[0])

    def interval(self, pattern: np.ndarray) -> Tuple[int, int, int]:
        """(lo, lo_rev, size) of the pattern window (left extension)."""
        p = np.asarray(pattern, dtype=np.int64)
        lo, lo_rev, size = self.whole(1)
        for c in p[::-1]:
            lo, lo_rev, size = self.extend_left(
                jnp.asarray([int(c)]), lo, lo_rev, size)
        return (int(np.asarray(lo)[0]), int(np.asarray(lo_rev)[0]),
                int(np.asarray(size)[0]))

"""Windowed per-block suffix sorting for the merge engine.

The reference sorts each block in RAM with divsufsort plus a gt-bitvector
resolving comparisons that run past the block boundary (SURVEY.md section
3.1 phase 2, hard-part 3). Device redesign: sort the block's suffixes by
doubling over a lookahead *window* [s, s+W) of the circular text (W =
block length + lookahead), **twice** — once treating out-of-window as the
smallest possible tail and once as the largest. The true circular order
lies between these two extremes, so if both sorts agree on the block's
suffixes every comparison was decided inside the window; otherwise the
caller doubles the lookahead (the ``largelcpthres`` escape of
bwtb3m.cpp:55 in spirit).
"""

from __future__ import annotations

import math
from functools import partial
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax


def _window_order_body(window: jnp.ndarray, sigma: int, pad_high: bool,
                       la: int):
    """Order of all window suffixes by non-circular comparison, with
    out-of-window treated as -inf (pad_high=False) or +inf (True).
    Ties (identical clamped suffixes) break by position.

    Also returns a FAST-RESOLUTION flag: the doubling finished (all W
    clamped ranks distinct) with total compared length <= la.  Every
    block suffix (position < W - la) has more than ``la`` real window
    symbols, so under that flag every decision between two block
    suffixes consumed only real text — the order restricted to block
    positions is certainly the true rotation order and the opposite-pad
    confirmation sort is unnecessary (it would agree).  For random
    texts this halves the block-sort work (a dominant phase of a large
    build)."""
    W = window.shape[0]
    pos = lax.broadcasted_iota(jnp.int32, (W,), 0)
    # shift symbols to 1..sigma so 0 (pad low) / sigma+1 (pad high) are
    # strictly outside the alphabet
    ext_sigma = sigma + 2
    bits = max(1, math.ceil(math.log2(ext_sigma)))
    w = max(1, 32 // bits)
    pad_val = jnp.uint32(sigma + 1 if pad_high else 0)
    u = window.astype(jnp.uint32) + 1

    def packed_key(offset: int) -> jnp.ndarray:
        key = jnp.zeros(W, dtype=jnp.uint32)
        for j in range(w):
            o = min(offset + j, W)  # fully-past-end shifts are all padding
            shifted = jnp.concatenate(
                [u[o:], jnp.full((o,), pad_val, jnp.uint32)]) if o else u
            key = (key << bits) | shifted
        return key

    # three packed words resolve 3w symbols before any doubling round:
    # at 2w symbols a 128M-suffix DNA window expects thousands of
    # birthday collisions (C(n,2)/4^20), forcing one full doubling
    # round to separate a few thousand ties; 3w makes collisions on
    # random text vanishingly rare, so the while_loop usually runs ZERO
    # rounds
    k1_s, k2_s, k3_s, p_s = lax.sort(
        (packed_key(0), packed_key(w), packed_key(2 * w), pos),
        num_keys=3, is_stable=True)
    changed = (k1_s[1:] != k1_s[:-1]) | (k2_s[1:] != k2_s[:-1]) \
        | (k3_s[1:] != k3_s[:-1])
    neq = jnp.concatenate(
        [jnp.zeros(1, jnp.int32), changed.astype(jnp.int32)])
    r_s = jnp.cumsum(neq, dtype=jnp.int32)
    rank = jnp.zeros(W, dtype=jnp.int32).at[p_s].set(r_s)
    pad_rank = jnp.int32(W + 1 if pad_high else -1)
    w = min(3 * w, max(W, 1))

    def cond(carry):
        _r, _sa, k, done = carry
        return jnp.logical_and(jnp.logical_not(done), k < W)

    def body(carry):
        rank, _sa, k, _done = carry
        idx2 = pos + k
        r2 = jnp.where(idx2 < W, jnp.take(rank, jnp.minimum(idx2, W - 1)),
                       pad_rank)
        r1_s, r2_s, p_s = lax.sort((rank, r2, pos), num_keys=3, is_stable=False)
        changed = jnp.logical_or(r1_s[1:] != r1_s[:-1], r2_s[1:] != r2_s[:-1])
        neq = jnp.concatenate(
            [jnp.zeros(1, jnp.int32), changed.astype(jnp.int32)])
        nr_s = jnp.cumsum(neq, dtype=jnp.int32)
        nrank = jnp.zeros(W, dtype=jnp.int32).at[p_s].set(nr_s)
        done = nr_s[-1] == jnp.int32(W - 1)
        # k after the body = total compared length of this round (2k)
        return (nrank, p_s, k * 2, done)

    done0 = r_s[-1] == jnp.int32(W - 1)
    _rank, sa, k_fin, done = lax.while_loop(
        cond, body, (rank, p_s, jnp.int32(w), done0))
    fast = jnp.logical_and(done, k_fin <= jnp.int32(la))
    return sa, fast


@partial(jax.jit, static_argnums=(1, 2))
def _window_order(window: jnp.ndarray, sigma: int, pad_high: bool) -> jnp.ndarray:
    return _window_order_body(window, sigma, pad_high, 0)[0]


@partial(jax.jit, static_argnums=(1, 2, 3))
def _window_order_flag(window: jnp.ndarray, sigma: int, pad_high: bool,
                       la: int):
    return _window_order_body(window, sigma, pad_high, la)


def block_suffix_order(window: np.ndarray, block_len: int, sigma: int
                       ) -> Tuple[np.ndarray, bool]:
    """Sort the first `block_len` window positions by circular-text rotation
    order, decided within the window.

    Returns (pad_low order, pad_high order, resolved flag), each order over
    [0, block_len) as window offsets. When resolved, both orders agree and
    either is the true circular order. When the window spans the whole
    rotation for every block position (W >= block_len + n), any remaining
    disagreement is between *genuinely equal rotations*, whose true order
    is the position tie-break — the pad_high order (the longer-available
    suffix sorts first, i.e. smaller positions first).
    """
    window = np.asarray(window, dtype=np.int32)
    win_dev = jnp.asarray(window)
    return block_suffix_order_window(win_dev, block_len, sigma)


def block_suffix_order_window(win_dev, block_len: int, sigma: int
                              ) -> Tuple[np.ndarray, np.ndarray, bool]:
    """block_suffix_order for a window already resident on device (the
    scaled engine slices it from the device text rows — no host gather or
    upload per block)."""
    lo_b, hi_b, resolved = block_suffix_order_device(
        win_dev, block_len, sigma)
    return (np.asarray(lo_b, np.int64), np.asarray(hi_b, np.int64),
            bool(resolved))


@partial(jax.jit, static_argnums=(1, 2))
def _block_filter(sa_full: jnp.ndarray, block_len: int, W: int):
    """Keep only the block's own positions, in order (device)."""
    idx = jnp.flatnonzero(sa_full < block_len, size=block_len, fill_value=0)
    return jnp.take(sa_full, idx)


@partial(jax.jit, static_argnums=(1, 2))
def _order_pair(win_dev, block_len: int, sigma: int):
    """Both-pad confirmation in ONE program: the hi sort runs only when
    the lo doubling's fast-resolution flag is off (lax.cond skips it at
    runtime — for random text the block sort is ONE doubling sort, not
    two).  Returns (lo order, hi order, mismatch count over block
    positions); hi == lo when the fast flag fired."""
    W = int(win_dev.shape[0])
    la = W - block_len
    lo_sa, fast = _window_order_body(win_dev, int(sigma), False, la)
    lo_b = _block_filter(lo_sa, int(block_len), W)

    def confirm(_):
        hi_sa = _window_order_body(win_dev, int(sigma), True, 0)[0]
        hi_b = _block_filter(hi_sa, int(block_len), W)
        return hi_b, jnp.sum((lo_b != hi_b).astype(jnp.int32))

    hi_b, mism = lax.cond(
        fast, lambda _: (lo_b, jnp.int32(0)), confirm, operand=None)
    return lo_b, hi_b, mism


def block_suffix_order_async(win_dev, block_len: int, sigma: int):
    """Dispatch-only variant: returns (lo order, hi order, mismatch
    count) as DEVICE arrays with no sync — the scaled engine dispatches
    every block's sort before fetching any flag, so device work and
    host round trips overlap across blocks."""
    return _order_pair(win_dev, int(block_len), int(sigma))


def block_suffix_order_device(win_dev, block_len: int, sigma: int):
    """Device-resident variant: returns (lo order, hi order, resolved) with
    the orders as int32 device arrays and only a scalar fetched — the
    scaled engine derives BWT/samples on device, so the two [W] suffix
    orders never leave the device."""
    lo_b, hi_b, mism = block_suffix_order_async(win_dev, block_len, sigma)
    return lo_b, hi_b, bool(int(mism) == 0)

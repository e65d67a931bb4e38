"""Succinct PLCP (permuted LCP) construction — equivalent of ``lcpbit``.

The reference (/root/reference/src/lcpbit.cpp, 4,084 LoC — the largest
in-repo algorithm) builds the 2n-bit unary-coded PLCP bit vector
semi-externally: rounds of external-memory stable radix sorts perform one
simultaneous LF step of all positions per round, with an irreducible-PLCP
optimization and a Kärkkäinen–Kempa Phi finish (SURVEY.md section 3.4).

Device redesign: with the doubling sorter's intermediate rank arrays
kept (one int32 level per doubling round), every PLCP entry is computed
*independently and in parallel* by binary-lifting descent:

    PLCP[p] = lcp(rotation p, rotation Phi(p)),  Phi(p) = SA[ISA[p]-1]
    lcp(x, y): for level j from high to low:
        if rank_j[x+l] == rank_j[y+l]: l += w * 2^j      (all mod n)
    then < w final single-symbol compares.

Level j's dense rank array orders rotations by their first w*2^j symbols
(doubling invariant), so the equality test is exact; levels past
convergence reuse the final (all-distinct) ranks, which remains exact.
Every step is a batched gather + compare over all n lanes — the device shape
of lcpbit's "one LF round = one radix pass over everything".

Succinct encoding (classic 2n-bit PLCP): bit stream
``0^{d_0} 1 0^{d_1} 1 ...`` with d_0 = PLCP[0],
d_p = PLCP[p] - PLCP[p-1] + 1; then PLCP[p] = select1(p) - 2p.
File format "PLB1" (FORMATS.md): magic, n, nbits, u64 words (LSB-first).
"""

from __future__ import annotations

import math
from functools import partial
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from ..ops.doubling import _pack_width
from ..util import serial

MAGIC = b"PLB1"


# --------------------------------------------------------------------------
# doubling with retained levels
# --------------------------------------------------------------------------

@partial(jax.jit, static_argnums=(1, 2))
def _doubling_with_levels(sym: jnp.ndarray, sigma: int, n_levels: int):
    """Like ops.doubling.suffix_array_jax but unrolled, returning the rank
    array of every level (level j orders by the first w*2^j symbols)."""
    n = sym.shape[0]
    pos = lax.broadcasted_iota(jnp.int32, (n,), 0)
    bits = max(1, math.ceil(math.log2(max(2, sigma))))
    w = _pack_width(sigma)

    key = jnp.zeros(n, dtype=jnp.uint32)
    u = sym.astype(jnp.uint32)
    for j in range(w):
        key = (key << bits) | jnp.roll(u, -j)
    k_s, p_s = lax.sort((key, pos), num_keys=1, is_stable=True)
    neq = jnp.concatenate(
        [jnp.zeros(1, jnp.int32), (k_s[1:] != k_s[:-1]).astype(jnp.int32)]
    )
    r_s = jnp.cumsum(neq, dtype=jnp.int32)
    rank = jnp.zeros(n, dtype=jnp.int32).at[p_s].set(r_s)

    levels = [rank]
    sa = p_s
    k = w
    for _lev in range(1, n_levels):
        idx2 = jnp.where(pos + k >= n, pos + k - n, pos + k)
        r2 = jnp.take(rank, idx2)
        r1_s, r2_s, p_s = lax.sort((rank, r2, pos), num_keys=2, is_stable=True)
        changed = jnp.logical_or(r1_s[1:] != r1_s[:-1], r2_s[1:] != r2_s[:-1])
        neq = jnp.concatenate(
            [jnp.zeros(1, jnp.int32), changed.astype(jnp.int32)]
        )
        nr_s = jnp.cumsum(neq, dtype=jnp.int32)
        rank = jnp.zeros(n, dtype=jnp.int32).at[p_s].set(nr_s)
        sa = p_s
        levels.append(rank)
        k = min(k * 2, n)
    return jnp.stack(levels), sa


@partial(jax.jit, static_argnums=(3, 4))
def _plcp_descent(sym: jnp.ndarray, levels: jnp.ndarray, sa: jnp.ndarray,
                  sigma: int, n_levels: int) -> jnp.ndarray:
    """Vectorized binary-lifting PLCP over all positions."""
    n = sym.shape[0]
    w = _pack_width(sigma)
    isa = jnp.zeros(n, jnp.int32).at[sa].set(
        lax.broadcasted_iota(jnp.int32, (n,), 0))
    # Phi: previous suffix in rank order (rank 0 wraps to rank n-1; its
    # PLCP is forced to 0 below)
    prev_rank = jnp.where(isa == 0, n - 1, isa - 1)
    phi = jnp.take(sa, prev_rank)

    p = lax.broadcasted_iota(jnp.int32, (n,), 0)
    q = phi
    l = jnp.zeros(n, jnp.int32)
    for j in range(n_levels - 1, -1, -1):
        span = min(w << j, n)
        pj = (p + l) % n
        qj = (q + l) % n
        eq = jnp.take(levels[j], pj) == jnp.take(levels[j], qj)
        ok = jnp.logical_and(eq, l + span <= n)
        l = jnp.where(ok, l + span, l)
    # final < w single-symbol steps (sequential per lane, masked)
    alive = l < n
    for _t in range(w):
        pj = (p + l) % n
        qj = (q + l) % n
        eq = jnp.take(sym, pj) == jnp.take(sym, qj)
        step = jnp.logical_and(jnp.logical_and(alive, eq), l < n)
        l = jnp.where(step, l + 1, l)
        alive = step
    # the globally smallest rotation has no predecessor
    l = l.at[jnp.take(sa, jnp.zeros((), jnp.int32))].set(0)
    return l


# --------------------------------------------------------------------------
# scaled path: batched-lane Kasai/Phi machine (memory O(n), not O(n log n))
# --------------------------------------------------------------------------
#
# The level-retaining descent above stores n x log2(n/w) int32 rank levels
# (~9 GB at 100M) — fine for small texts, impossible at reference scale.
# The scaled path is the device shape of the
# reference's Kärkkäinen–Kempa Phi phase (lcpbit.cpp:2371-2850): split the
# position space into L contiguous lanes; each lane runs Kasai's amortized
# scan (PLCP[p] >= PLCP[p-1] - 1, so l only needs to re-extend by the
# delta); all lanes step in lockstep, each step one batched text compare at
# (p+l, q+l). Total steps ~= 2*(n/L) + max warm-up extension.

# (the round-3 one-symbol-per-step row-gather slab kernel was replaced
# by routing the slab path through the word-window kernel below — same
# slab addressing, 8x / 4x fewer steps)


# --------------------------------------------------------------------------
# device-resident path: full SA/ISA/Phi in HBM + word-window Kasai
# --------------------------------------------------------------------------
#
# The slab machine pays (a) fetching the rate-1 SA and re-uploading
# phi/isa slabs (host round trips), and (b) a per-step [L, 128] row
# gather + 128-wide mask select per text read.  This path keeps EVERYTHING in
# HBM (sa from the LF walk never leaves the device; isa/phi are device
# scatters; the succinct bit vector is encoded on device and only the
# packed words are downloaded) and extends matches 8 symbols per step:
# one u32 window holds 8 nibbles, XOR + lowest-set-bit popcount counts
# the matching prefix exactly.  Reference role: lcpbit's Phi finish
# (/root/reference/src/lcpbit.cpp:2371-2850) whose inner loop is the
# same naive circular extension, batched here over 2^17 lanes.

def _pack_text_words(text: np.ndarray, sigma: int = 16) -> np.ndarray:
    """Host int32/uint8 symbols -> uint32 words of LSB-first symbols
    (8 nibbles/word for sigma <= 16, 4 bytes/word for sigma <= 256),
    one pad word for cross-boundary window reads.  The reference handles
    arbitrary alphabets by rank-compacting to <= 256 dense symbols and
    running the same machinery (/root/reference/src/lcpbit.cpp:677-806);
    here the byte layout IS that dense path."""
    from .. import native
    t = np.ascontiguousarray(text, np.uint8)
    spw = 8 if sigma <= 16 else 4  # symbols per u32 word
    pad = (-len(t)) % spw
    if pad:
        t = np.concatenate([t, np.zeros(pad, np.uint8)])
    if sigma <= 16:
        packed = native.pack_bits_u8(t, 4)
        if packed is None:
            from ..io.compact import pack_bits
            packed = np.asarray(pack_bits(t.astype(np.int64), 4), np.uint8)
    else:
        packed = t
    words = np.frombuffer(
        np.concatenate([np.asarray(packed, np.uint8),
                        np.zeros(4, np.uint8)]).tobytes(), "<u4")
    return words.copy()


def _kasai_chunk2_impl(steps: int, bits: int, text_words, phi, isa, plcp,
                       p, l, pend, n, a):
    """Word-window batched Kasai: each step either commits PLCP[p] = l
    or extends the current match by 1..spw symbols (the XOR-popcount
    count of matching nibbles/bytes in one u32 window); ``bits`` is 4
    (sigma <= 16, 8 symbols per window) or 8 (byte alphabets, 4)."""
    from ..ops.idx64 import take_u32

    idx_sh = jnp.uint32(3 if bits == 4 else 2)   # symbols->words shift
    idx_msk = jnp.uint32(7 if bits == 4 else 3)
    sym_sh = jnp.uint32(2 if bits == 4 else 3)   # popcount bits->symbols

    def win(idx):
        wi = idx >> idx_sh
        w0 = take_u32(text_words, wi)
        w1 = take_u32(text_words, wi + jnp.uint32(1))
        sh = (idx & idx_msk) * jnp.uint32(bits)
        lo = w0 >> sh
        hi = jnp.where(sh == 0, jnp.uint32(0),
                       w1 << (jnp.uint32(32) - sh))
        return lo | hi

    slab = plcp.shape[0] - 1

    def sl(p):
        return jnp.minimum(p - a, jnp.uint32(slab - 1)).astype(jnp.int32)

    def body(_i, carry):
        plcp, p, l, q = carry
        active = p < pend
        r = jnp.take(isa, sl(p))
        has_prev = r != 0
        pl = p + l
        pl = jnp.where(pl >= n, pl - n, pl)
        ql = q + l
        ql = jnp.where(ql >= n, ql - n, ql)
        x = win(pl) ^ win(ql)
        # matching symbol count: lowest set bit's symbol index; x == 0
        # falls out as popcount(0xFFFFFFFF) >> sym_sh = spw
        k = (lax.population_count((x & (jnp.uint32(0) - x))
                                  - jnp.uint32(1)) >> sym_sh)
        k = jnp.minimum(jnp.minimum(k, n - pl),
                        jnp.minimum(n - ql, n - l))
        extend = jnp.logical_and(jnp.logical_and(active, has_prev),
                                 k >= 1)
        commit = jnp.logical_and(active, jnp.logical_not(extend))
        val = jnp.where(has_prev, l, 0)
        idx = jnp.where(commit, (p - a).astype(jnp.int32), slab)
        plcp = plcp.at[idx].set(val, mode="drop")
        lnext = jnp.where(extend, l + k, l)
        dec = jnp.logical_and(commit, jnp.logical_and(has_prev, l > 0))
        lnext = jnp.where(dec, l - 1, lnext)
        lnext = jnp.where(jnp.logical_and(commit,
                                          jnp.logical_not(has_prev)),
                          jnp.uint32(0), lnext)
        l = lnext
        p = jnp.where(commit, p + 1, p)
        q2 = jnp.take(phi, sl(p))
        q = jnp.where(commit, q2, q)
        return (plcp, p, l, q)

    q0 = jnp.take(phi, sl(p))
    plcp, p, l, q = lax.fori_loop(0, steps, body, (plcp, p, l, q0))
    return plcp, p, l


_kasai_chunk2 = partial(jax.jit, static_argnums=(0, 1),
                        donate_argnums=(5,))(_kasai_chunk2_impl)


def compute_plcp_device(text: np.ndarray, sigma: int, sa_dev,
                        lanes: int = 1 << 17):
    """Fully device-resident PLCP for texts whose SA/ISA/Phi fit HBM
    (~17 B/symbol): sa_dev is the DEVICE uint32 rate-1 SA (e.g. from
    engine.ssa.compute_sa_device — it never leaves the device).
    Any sigma <= 256 (byte windows for sigma > 16 — the dense-alphabet
    path of /root/reference/src/lcpbit.cpp:677-806).
    Returns the device uint32 PLCP array [n]."""
    from ..ops.idx64 import scatter_set_u32

    n = len(text)
    assert sigma <= 256 and n < (1 << 31)
    bits = 4 if sigma <= 16 else 8
    words = jnp.asarray(_pack_text_words(text, sigma))
    iota = lax.broadcasted_iota(jnp.uint32, (n,), 0)
    sa32 = sa_dev.astype(jnp.uint32)
    isa = scatter_set_u32(jnp.zeros(n, jnp.uint32), sa32, iota)
    phi = scatter_set_u32(jnp.zeros(n, jnp.uint32), sa32[1:], sa32[:-1])
    L = min(lanes, n)
    bounds = np.linspace(0, n, L + 1).astype(np.int64)
    p = jnp.asarray(bounds[:-1].astype(np.uint32))
    pend = jnp.asarray(bounds[1:].astype(np.uint32))
    l = jnp.zeros(L, jnp.uint32)
    plcp_dev = jnp.zeros(n + 1, jnp.uint32)
    while True:
        plcp_dev, p, l = _kasai_chunk2(
            2048, bits, words, phi, isa, plcp_dev, p, l, pend,
            jnp.uint32(n), jnp.uint32(0))
        if bool(np.asarray(jnp.all(p >= pend))):
            break
    return plcp_dev[:n]


def encode_plcp_bits_device(plcp_dev) -> Tuple[int, np.ndarray]:
    """Succinct 2n-bit unary encoding ON DEVICE; only the packed bytes
    reach the host (16x less than the PLCP values).  Returns
    (nbits, bytes little-bit-endian)."""
    from ..ops.idx64 import scatter_set_u32

    n = int(plcp_dev.shape[0])
    if n == 0:
        return 0, np.zeros(0, np.uint8)
    last = int(plcp_dev[n - 1]) + 2 * (n - 1)
    nbits = last + 1
    nbytes = (nbits + 7) // 8

    @partial(jax.jit, static_argnums=(1,))
    def enc(plcp, nb: int):
        iota = lax.broadcasted_iota(jnp.uint32, (plcp.shape[0],), 0)
        one_pos = plcp + jnp.uint32(2) * iota
        bits = scatter_set_u32(jnp.zeros(nb * 8, jnp.uint8), one_pos,
                               jnp.ones(plcp.shape[0], jnp.uint8))
        out = jnp.zeros(nb, jnp.uint8)
        for b in range(8):
            out = out | (bits[b::8] << jnp.uint8(b))
        return out

    by = np.asarray(enc(plcp_dev, nbytes), np.uint8)
    return nbits, by


def write_plcp_bytes(path: str, n: int, nbits: int,
                     by: np.ndarray) -> None:
    """PLB1 writer from pre-packed bits (device encoder output)."""
    pad = (-len(by)) % 8
    if pad:
        by = np.concatenate([by, np.zeros(pad, np.uint8)])
    words = by.view("<u8")
    with open(path, "wb") as f:
        f.write(MAGIC)
        serial.write_u64(f, n)
        serial.write_u64(f, nbits)
        serial.write_u64_array(f, np.asarray(words, np.uint64))


def compute_plcp_scaled(text: np.ndarray, sigma: Optional[int] = None,
                        lanes: int = 1 << 17, sa_isa=None,
                        slab_positions: int = 1 << 28
                        ) -> Tuple[np.ndarray, np.ndarray]:
    """O(slab)-device-memory PLCP: SA + batched-lane Kasai over
    host-staged position slabs. Returns (plcp int64 [n], sa int64 [n]).

    Only the packed text words (0.5 B/symbol for sigma <= 16, 1 B for
    byte alphabets) stay device-resident across slabs; phi/isa/plcp
    travel per 256 M-position slab (~3 GB device peak), so the machine
    scales to any text the HOST holds — the device shape of lcpbit's
    external-memory phases (lcpbit.cpp:2371-2850).  ``sa_isa`` supplies
    a precomputed (sa, isa) pair (e.g. from the merge engine + rate-1
    LF walk) to skip the doubling sort.  Any sigma <= 256: the per-step
    extension runs on u32 text-word windows (8 nibbles or 4 bytes per
    compare — the same kernel as the device-resident path)."""
    text = np.asarray(text, dtype=np.int32)
    n = len(text)
    if sigma is None:
        sigma = int(text.max()) + 1 if n else 1
    if n <= 1:
        return np.zeros(n, np.int64), np.zeros(n, np.int64)
    if sigma > 256:
        raise ValueError("scaled PLCP supports sigma <= 256; rank-compact "
                         "the alphabet first (compute_plcp does)")
    if sa_isa is not None:
        sa, isa_np = sa_isa
        sa = np.asarray(sa)
        isa_np = np.asarray(isa_np)
    else:
        from ..ops.doubling import suffix_array
        sa, isa, _bwt = suffix_array(text, sigma)
        sa = np.asarray(sa)
        isa_np = np.asarray(isa).astype(np.int64)
    phi = np.zeros(n, np.uint32)
    # Phi[p] = SA[ISA[p] - 1]; rank 0 committed as 0 by the kernel
    phi[sa[1:]] = sa[:-1].astype(np.uint32)
    bits = 4 if sigma <= 16 else 8
    words = jnp.asarray(_pack_text_words(text, sigma))
    plcp_host = np.zeros(n, np.int64)
    slab = min(slab_positions, n)
    for a in range(0, n, slab):
        b = min(n, a + slab)
        L = min(lanes, b - a)
        bounds = np.linspace(a, b, L + 1).astype(np.int64)
        p = jnp.asarray(bounds[:-1].astype(np.uint32))
        pend = jnp.asarray(bounds[1:].astype(np.uint32))
        l = jnp.zeros(L, jnp.uint32)
        # fixed slab shape (+1 drop slot) so every slab reuses one
        # compiled program; the tail slab pads
        plcp_dev = jnp.zeros(slab + 1, jnp.uint32)
        phi_dev = jnp.asarray(_padto(phi[a:b], slab))
        isa_dev = jnp.asarray(
            _padto(isa_np[a:b].astype(np.uint32), slab))
        while True:
            plcp_dev, p, l = _kasai_chunk2(
                2048, bits, words, phi_dev, isa_dev, plcp_dev, p, l,
                pend, jnp.uint32(n), jnp.uint32(a))
            if bool(np.asarray(jnp.all(p >= pend))):
                break
        plcp_host[a:b] = np.asarray(plcp_dev)[: b - a]
    return plcp_host, sa.astype(np.int64)


def _padto(arr: np.ndarray, size: int) -> np.ndarray:
    if len(arr) == size:
        return arr
    out = np.zeros(size, arr.dtype)
    out[: len(arr)] = arr
    return out


def compute_plcp(text: np.ndarray, sigma: Optional[int] = None
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """Returns (plcp int64 [n], sa int64 [n]) for the circular text.

    Small texts use the level-retaining binary-lifting descent (fewest
    dispatches); anything big enough that n*log(n) rank levels would
    strain HBM routes to the O(n)-memory batched Kasai machine."""
    text = np.asarray(text, dtype=np.int32)
    n = len(text)
    if sigma is None:
        sigma = int(text.max()) + 1 if n else 1
    if n == 0:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    if n == 1:
        return np.zeros(1, np.int64), np.zeros(1, np.int64)
    if sigma > 256:
        # alphabet rank-compaction to <= 256 dense symbols (reference:
        # /root/reference/src/lcpbit.cpp:677-806).  A strictly monotonic
        # remap preserves both rotation order (so SA is unchanged) and
        # symbol equality (so every LCP value is unchanged).
        uniq = np.unique(text)
        if len(uniq) <= 256:
            text = np.searchsorted(uniq, text).astype(np.int32)
            sigma = len(uniq)
    if n > (1 << 22) and sigma <= 256:
        from ..util.devmem import device_budget
        budget = device_budget("BWTB3M_PLCP_DEV_BYTES")
        # 18 B/symbol at sigma <= 16 (nibble-packed words); byte windows
        # for wider alphabets add 0.5 B/symbol
        per = 18 if sigma <= 16 else 19
        if n * per <= budget:
            # SA/ISA/Phi/PLCP all fit HBM: device-resident fast path
            from ..ops.doubling import suffix_array
            sa, _isa, _bwt = suffix_array(text, sigma)
            plcp_dev = compute_plcp_device(
                text, sigma, jnp.asarray(np.asarray(sa),
                                         dtype=jnp.uint32))
            return (np.asarray(plcp_dev).astype(np.int64),
                    np.asarray(sa, dtype=np.int64))
        return compute_plcp_scaled(text, sigma)
    w = _pack_width(sigma)
    n_levels = 1
    while w * (1 << (n_levels - 1)) < n:
        n_levels += 1
    sym = jnp.asarray(text)
    levels, sa = _doubling_with_levels(sym, int(sigma), n_levels)
    plcp = _plcp_descent(sym, levels, sa, int(sigma), n_levels)
    return (np.asarray(plcp, dtype=np.int64),
            np.asarray(sa, dtype=np.int64))


# --------------------------------------------------------------------------
# succinct encoding
# --------------------------------------------------------------------------

def encode_plcp_bits(plcp: np.ndarray) -> np.ndarray:
    """PLCP -> unary delta bit array (uint8 0/1)."""
    plcp = np.asarray(plcp, dtype=np.int64)
    n = len(plcp)
    if n == 0:
        return np.zeros(0, np.uint8)
    deltas = np.empty(n, dtype=np.int64)
    deltas[0] = plcp[0]
    deltas[1:] = plcp[1:] - plcp[:-1] + 1
    assert (deltas >= 0).all(), "PLCP violates the p+1 >= p-1 invariant"
    total = int(deltas.sum()) + n
    bits = np.zeros(total, dtype=np.uint8)
    one_pos = np.cumsum(deltas + 1) - 1
    bits[one_pos] = 1
    return bits


def decode_plcp_bits(bits: np.ndarray, n: int) -> np.ndarray:
    ones = np.flatnonzero(np.asarray(bits))
    if len(ones) != n:
        raise ValueError("expected %d ones, found %d" % (n, len(ones)))
    return ones - 2 * np.arange(n, dtype=np.int64)


class PLCPBitDecoder:
    """Reader for .lcpbit files (reference ``lcp::PLCPBitDecoder``,
    /root/reference/src/checkLCPBit.cpp:67)."""

    def __init__(self, path: str, n: Optional[int] = None):
        with open(path, "rb") as f:
            if f.read(4) != MAGIC:
                raise ValueError("not a PLB1 file: %s" % path)
            self.n = serial.read_u64(f)
            nbits = serial.read_u64(f)
            nwords = (nbits + 63) // 64
            words = serial.read_u64_array(f, nwords)
        if n is not None and n != self.n:
            raise ValueError("length mismatch: file n=%d, expected %d" % (self.n, n))
        bits = np.unpackbits(
            words.astype("<u8").view(np.uint8), bitorder="little"
        )[:nbits]
        self._plcp = decode_plcp_bits(bits, self.n)

    def get(self, p):
        return self._plcp[np.asarray(p, dtype=np.int64)]

    def all(self) -> np.ndarray:
        return self._plcp.copy()


def write_plcp_file(path: str, plcp: np.ndarray) -> None:
    bits = encode_plcp_bits(plcp)
    nbits = len(bits)
    padded = np.zeros(((nbits + 63) // 64) * 64, dtype=np.uint8)
    padded[:nbits] = bits
    words = np.packbits(padded, bitorder="little").view(np.uint64)
    with open(path, "wb") as f:
        f.write(MAGIC)
        serial.write_u64(f, len(plcp))
        serial.write_u64(f, nbits)
        serial.write_u64_array(f, words)


# --------------------------------------------------------------------------
# file-level drivers
# --------------------------------------------------------------------------

def _text_from_bwt_meta(bwt_path: str) -> Tuple[np.ndarray, int]:
    from ..engine.result import BwtResult
    from ..io.inputtypes import parse_input_type

    result = BwtResult.load(bwt_path)
    itype = parse_input_type(result.meta["inputtype"])
    return itype.load(result.meta["input"])


def compute_plcp_file(bwt_path: str, out_path: str) -> str:
    """lcpbit driver: text (via the .meta manifest) -> .lcpbit."""
    text, sigma = _text_from_bwt_meta(bwt_path)
    plcp, _sa = compute_plcp(text, sigma)
    write_plcp_file(out_path, plcp)
    return out_path


def kasai_plcp(text: np.ndarray, sa: np.ndarray) -> np.ndarray:
    """Independent host oracle: Phi + direct compare (circular), the
    verification method of checkLCPBit (recompute-and-compare)."""
    text = np.asarray(text)
    n = len(text)
    from .. import native
    nat = native.kasai_plcp(text, np.asarray(sa))
    if nat is not None:
        return nat
    isa = np.zeros(n, dtype=np.int64)
    isa[sa] = np.arange(n)
    plcp = np.zeros(n, dtype=np.int64)
    l = 0
    for p in range(n):
        r = isa[p]
        if r == 0:
            l = 0
            continue
        q = sa[r - 1]
        while l < n and text[(p + l) % n] == text[(q + l) % n]:
            l += 1
        plcp[p] = l
        l = max(0, l - 1)
    return plcp


def verify_plcp_file(lcpbit_path: str, bwt_path: str) -> bool:
    """checkLCPBit: verify the .lcpbit against an independently recomputed
    PLCP (reference checkLCPBit.cpp:62-82 recomputes the LCP via WaveletLCP
    and compares all entries; here the independent oracle is a host
    Phi/Kasai pass over the doubling SA)."""
    text, sigma = _text_from_bwt_meta(bwt_path)
    from ..ops.doubling import suffix_array

    sa, _isa, _bwtarr = suffix_array(text, sigma)
    return verify_plcp(lcpbit_path, text, sa)


def verify_plcp(lcpbit_path: str, text: np.ndarray, sa: np.ndarray) -> bool:
    dec = PLCPBitDecoder(lcpbit_path, n=len(text))
    ref = kasai_plcp(text, sa)
    return bool(np.array_equal(dec.all(), ref))

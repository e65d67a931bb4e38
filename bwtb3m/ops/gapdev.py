"""Device-resident gap-array computation — the scaled merge kernel.

Round-1's GapChainRunner (ops/gap.py) staged text/gt chunks from the host
every few thousand steps.  This rewrite keeps EVERYTHING on device:

- the packed text lives in device memory as int8 rows [*, 256] for the whole engine
  run; a chain step reads its symbol with a shared dynamic column slice
  (all lanes are phase-aligned: walk starts are padded up to ``255 mod
  256`` positions and masked, so every lane's position at global step k
  sits in the same column 255 - (k % 256) of its own row — one row gather
  per lane per 256 steps instead of a host gather per chunk);
- gt wrap-term bits are precomputed host-side by the native three-way
  rotation comparator (only for positions whose symbol can trigger the
  wrap term), shipped bit-packed, and read from a second tiny row gather;
- each step's rank query is ONE FusedOcc row gather (ops/focc.py);
- R values are emitted per step through ``lax.scan`` stacking (no
  loop-carried record buffer — the round-1 dead end) and folded into the
  gap histogram with one scatter-add per chunk; preisa-sample harvesting
  is a tiny take_along_axis on the same buffer.

Recurrence and semantics are identical to ops/gap.py (module docstring
there derives it; reference: SURVEY.md section 3.1 phase 3 HOT LOOP #2,
arXiv:1604.06687); anchoring is the same monotone interval contraction,
run as two extra lane batches (lower/upper bound) through the same
kernel.  All rank values stay < 2^31 inside one merge (the balanced tree
keeps every right region below 2^31 for n < 2^32), so lanes carry int32;
texts of 2^31..2^32 symbols need no wide path here.
"""

from __future__ import annotations

from functools import partial
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from .focc import FusedOcc, rank_batch_f

TEXT_BLOCK = 256


def _select_small(table: jnp.ndarray, idx: jnp.ndarray) -> jnp.ndarray:
    """table[idx[j]] for a small broadcastable table via compare-mask."""
    tab = jnp.broadcast_to(table[None, :], (idx.shape[0], table.shape[0]))
    col = lax.broadcasted_iota(jnp.int32, tab.shape, 1)
    return jnp.sum(jnp.where(col == idx[:, None], tab, 0), axis=1)


def _chain_step(focc: FusedOcc, c_first: jnp.ndarray, consts: jnp.ndarray,
                r: jnp.ndarray, c: jnp.ndarray, g0: jnp.ndarray,
                active: jnp.ndarray) -> jnp.ndarray:
    """One masked recurrence step for all lanes; returns updated r.

    All rank values are uint32 end-to-end (c_first, consts and the lane
    ranks): right regions up to 2^32-1 rotations are exact — an int32
    lane would corrupt every rank >= 2^31 through its signed compare
    against consts[0] (texts of 2^32..2^33 symbols hit this at the root
    merge)."""
    rk = rank_batch_f(focc, c, r)
    cnt_lt = _select_small(c_first, c)
    cu = c.astype(jnp.uint32)
    corr = jnp.logical_and(consts[0] < r, cu == consts[1]).astype(jnp.uint32)
    wrap = jnp.logical_and(cu == consts[2], g0 == 1).astype(jnp.uint32)
    r_new = cnt_lt + rk - corr + wrap
    return jnp.where(active, r_new, r)


def _read_tg(text_rows, gt_rows, start_rows, lo0_row, kbase):
    """Row gathers for one 256-step window: text rows (256 raw bytes or
    128 nibble-packed bytes per 256 symbols — see build_text_rows) +
    packed gt rows.

    Lanes are addressed by their ABSOLUTE text row index (start_rows,
    int32 — < 2^25 even at 2^33 symbols), not by a flat symbol offset:
    walk starts are phase-aligned to 255 mod 256 so column arithmetic
    never leaves the row, and row indices keep every position width out
    of the kernel."""
    prow = jnp.maximum(start_rows - (kbase >> 8), 0)
    trow = jnp.take(
        text_rows, jnp.minimum(prow, text_rows.shape[0] - 1),
        axis=0)                                # [T, 256] or [T, 128] int8
    grow = jnp.take(
        gt_rows, jnp.minimum(jnp.maximum(prow - lo0_row, 0),
                             gt_rows.shape[0] - 1), axis=0)  # [T, 32]
    return trow, grow


def chunk_outer(remaining: int) -> int:
    """Outer-loop length (in 256-step windows) for the next walk chunk of
    every chain, anchor, verify and ssa driver: ceil(remaining / 256)
    rounded DOWN to the {8, 4, 2, 1} power-of-two family.  Each distinct
    ``outer`` is a separate compile of the chunk kernel, so the family
    caps the variants at four per shape while the masked overshoot past
    the end of the walk stays below 256 steps."""
    need = max(1, (remaining + 255) // 256)
    if need >= 8:
        return 8
    return 1 << (need.bit_length() - 1)


def _col_read(trow, grow, i):
    col = 255 - i
    if trow.shape[1] == TEXT_BLOCK // 2:
        # nibble-packed rows (sigma <= 16): byte col>>1, low nibble first
        byte = lax.dynamic_slice_in_dim(
            trow, col >> 1, 1, axis=1)[:, 0].astype(jnp.int32) & 0xFF
        c = (byte >> ((col & 1) * 4)) & 0xF
    else:
        # & 0xFF: raw byte rows are int8 bit patterns; symbols >= 128
        # (bytestream alphabets) must not sign-extend
        c = lax.dynamic_slice_in_dim(trow, col, 1, axis=1)[:, 0].astype(
            jnp.int32) & 0xFF
    gbyte = lax.dynamic_slice_in_dim(grow, col >> 3, 1, axis=1)[:, 0]
    g0 = ((gbyte >> (col & 7).astype(jnp.uint8)) & 1).astype(jnp.int32)
    return c, g0


def _chain_chunk_impl(outer: int, focc: FusedOcc, text_rows, gt_rows,
                      lo0_row, c_first, consts, start_rows, afrom, ato, gap,
                      r0, k0, samp_idx):
    """Run outer*256 steps for all lanes, recording every R into the gap
    histogram (out-of-range sentinel rows are dropped by the scatter) and
    harvesting the sample rows named by samp_idx. Returns (r, gap, samp).
    Plain traceable body — also the per-shard program of the mesh-sharded
    merge (parallel/merge.py shards the lane axis and keeps the occ rows
    replicated).

    The histogram is 2-D [rows, 256] (uint16 or int32): rank spaces past
    2^31 cells exceed the per-dimension buffer limit as a flat array, and
    the (row, col) scatter keeps uint32 rank indices exact."""
    # sentinel row 2^24 - 1 is out of range for every legal histogram
    # (run_chains asserts rank spaces stay 256 short of 2^32)
    sentinel = jnp.uint32(0xFFFFFFFF)

    def outer_body(r, o):
        kbase = k0 + o * 256
        trow, grow = _read_tg(text_rows, gt_rows, start_rows, lo0_row, kbase)

        def inner(r, i):
            c, g0 = _col_read(trow, grow, i)
            k = kbase + i
            active = jnp.logical_and(k >= afrom, k < ato)
            r = _chain_step(focc, c_first, consts, r, c, g0, active)
            y = jnp.where(active, r, sentinel)
            return r, y

        r, ys = lax.scan(inner, r, jnp.arange(256, dtype=jnp.int32))
        return r, ys

    r, ys = lax.scan(outer_body, r0, jnp.arange(outer, dtype=jnp.int32))
    ys_flat = ys.reshape(outer * 256, start_rows.shape[0])
    yr = ys_flat.reshape(-1)
    # row < 2^24 always fits int32; sentinel lands one row past the end
    gap = gap.at[(yr >> jnp.uint32(8)).astype(jnp.int32),
                 (yr & jnp.uint32(255)).astype(jnp.int32)].add(
        1, mode="drop")
    samp = jnp.take_along_axis(ys_flat, samp_idx, axis=0)
    return r, gap, samp


_chain_chunk = partial(jax.jit, static_argnums=(0,), donate_argnums=(10,))(
    _chain_chunk_impl)


def _anchor_chunk_impl(outer: int, focc: FusedOcc, text_rows, gt_rows,
                       lo0_row, c_first, consts, start_rows, afrom, ato, r0,
                       k0):
    """Same stepping without recording — used for both contraction bounds."""

    def outer_body(r, o):
        kbase = k0 + o * 256
        trow, grow = _read_tg(text_rows, gt_rows, start_rows, lo0_row, kbase)

        def inner(i, r):
            c, g0 = _col_read(trow, grow, i)
            k = kbase + i
            active = jnp.logical_and(k >= afrom, k < ato)
            return _chain_step(focc, c_first, consts, r, c, g0, active)

        return lax.fori_loop(0, 256, inner, r), 0

    r, _ = lax.scan(outer_body, r0, jnp.arange(outer, dtype=jnp.int32))
    return r


_anchor_chunk = partial(jax.jit, static_argnums=(0,))(_anchor_chunk_impl)


def _pad_pow2(x: int, lo: int = 1024) -> int:
    """Quarter-octave shape buckets (<= 4 per power of two): compile reuse
    without pow2's up-to-2x memory waste — the int32 gap histogram of a
    1.6 G-rank root merge pads to 7 GB instead of 8.6 GB."""
    x = max(lo, max(1, x))
    p = 1 << (x - 1).bit_length()
    for frac in (p // 2 + p // 8, p // 2 + p // 4, p // 2 + 3 * p // 8, p):
        if x <= frac:
            return frac
    return p


def build_text_rows(text: np.ndarray, sigma: int = 16) -> "jnp.ndarray":
    """Upload the whole text once as int8 rows covering 256 symbols each:
    nibble-packed [nrows, 128] for sigma <= 16 (half the HBM, and the
    rows stay the packed transfer — no device unpack pass), raw bytes
    [nrows, 256] for sigma <= 256.

    2-D rows are load-bearing beyond 2^31 symbols: int32 indices reach
    2^31-1 per dimension only (a flat int8 [2^31+1024] array read with
    them silently misreads), so the text must never be reshaped to 1-D
    at scale; readers address (row = pos>>8, col).
    Readers mask with & 0xFF against int8 sign extension."""
    n = len(text)
    nrows = (n + TEXT_BLOCK - 1) // TEXT_BLOCK
    npad = nrows * TEXT_BLOCK
    t = np.asarray(text, dtype=np.uint8)
    if npad != n:
        t = np.concatenate([t, np.zeros(npad - n, np.uint8)])
    if sigma > 16:
        return jnp.asarray(
            t.reshape(nrows, TEXT_BLOCK).view(np.int8))
    from .. import native
    packed = native.pack_bits_u8(t, 4)
    if packed is None:
        from ..io.compact import pack_bits
        packed = pack_bits(t.astype(np.int64), 4)
    return jnp.asarray(
        np.asarray(packed, np.uint8).reshape(nrows, TEXT_BLOCK // 2)
        .view(np.int8))


def upload_bwt(bwt: np.ndarray, sigma: int) -> "jnp.ndarray":
    """Host uint8 BWT -> device int8 array (4-bit packed transfer for
    sigma <= 16, raw bytes for wider alphabets)."""
    n = len(bwt)
    b = np.asarray(bwt, dtype=np.uint8)
    if sigma > 16:
        return jnp.asarray(b).astype(jnp.int8)
    from .. import native
    from .pack import unpack_bits_device
    pad = (-n) % 2
    if pad:
        b = np.concatenate([b, np.zeros(pad, np.uint8)])
    packed = native.pack_bits_u8(b, 4)
    if packed is None:
        from ..io.compact import pack_bits
        packed = pack_bits(b.astype(np.int64), 4)
    return unpack_bits_device(jnp.asarray(packed), 4, n + pad)[:n].astype(jnp.int8)


class DeviceGapRunner:
    """Anchored, fully device-resident gap computation for one pair merge
    of left block [s, m) into right region M = [m, e).

    The caller provides the engine-wide device text rows and host text
    (uint8; the native comparator wraps spans modularly).  ``compute``
    runs anchoring + chains and leaves the gap histogram on device;
    ``fetch_gap_compressed`` returns the byte-compressed histogram for the
    host interleave; ``cnt_le_at_host`` serves the right-side sample updates from the fetched compressed histogram.
    """

    WIDE = False      # ops/gapwide.WideDeviceGapRunner overrides

    def __init__(self, focc: FusedOcc, text_rows, text_host: np.ndarray,
                 s: int, m: int, e: int,
                 isa_m: int, first_hist: np.ndarray,
                 lane_bucket: int = 1 << 16, sample_rate: int = 0,
                 nthreads: int = 4, log=None, gap_dtype=None):
        self.focc = focc
        self.text_rows = text_rows
        self.text = text_host
        self.n = len(text_host)
        self.s, self.m, self.e = int(s), int(m), int(e)
        self.isa_m = int(isa_m)
        self.gap_size = self.e - self.m
        assert focc.n == self.gap_size
        self.lane_bucket = lane_bucket
        # uint16 histogram halves the dominant HBM buffer of a root merge
        # (3.2 GB instead of 6.4 GB at a 1.6 G-rank right region).  A cell
        # hit >= 2^16 times wraps — the caller detects it through the
        # gap_checksum() != block_len invariant (wraps only ever LOWER the
        # sum) and reruns the chains with int32 via run_chains(force_int32)
        self.gap_dtype = gap_dtype if gap_dtype is not None else jnp.uint16
        self.sample_rate = int(sample_rate)
        self.nthreads = nthreads
        self.log = log
        self.sigma = int(focc.sigma)
        block_len = self.m - self.s
        assert self.WIDE or block_len < (1 << 32), \
            "left block must stay below 2^32 (wide runner past that)"
        # c_first[c] = number of M rotations starting with a symbol < c
        self.c_first = jnp.asarray(
            np.concatenate([[0], np.cumsum(first_hist)[:-1]]).astype(np.uint32))
        self.sym_before_m = int(text_host[(self.m - 1) % self.n])
        self.sym_last = int(text_host[(self.e - 1) % self.n])
        self.consts = jnp.asarray(np.array(
            [self.isa_m, self.sym_before_m, self.sym_last], dtype=np.uint32))
        # gt coverage: positions p in [s, cap) with text[p] == sym_last can
        # trigger the wrap term; cap grows lazily when anchors extend
        self.lo0 = (self.s // TEXT_BLOCK) * TEXT_BLOCK
        self._gt_cap = 0
        self._gt_packed = None  # host uint8 [rows, 32]
        self.gt_rows = None
        self.gap = None
        self._samples: list = []
        self.final_rs = None
        self._lanes = None

    # ---------------------------------------------------------------- gt

    def _ensure_gt(self, cap: int) -> None:
        """Ensure wrap-term gt bits cover walk positions [s, cap)."""
        cap = min(cap, self.e - 1)  # walks never consult x = p+1 beyond e-1
        if cap <= self._gt_cap:
            return
        lo = max(self.s, self._gt_cap)
        ps = lo + np.flatnonzero(
            np.asarray(self.text[lo:cap]) == self.sym_last).astype(np.int64)
        xs = ps + 1  # the recurrence consults gt[p + 1]
        if len(xs):
            from .. import native
            bits = native.cmp_rot(self.text, self.n, self.e % self.n, xs,
                                  self.nthreads)
            if bits is not None:
                gt = (bits > 0).astype(np.uint8)
            else:
                from .gap import gt_against
                gt = gt_against(self.text.astype(np.int32), self.e % self.n, xs)
        else:
            gt = np.zeros(0, np.uint8)
        nrows = _pad_pow2(
            (cap + 1 - self.lo0 + TEXT_BLOCK - 1) // TEXT_BLOCK, lo=4)
        packed = np.zeros((nrows, TEXT_BLOCK // 8), np.uint8)
        if self._gt_packed is not None:
            packed[: self._gt_packed.shape[0]] = self._gt_packed
        # bit for walk position p lives at offset p - lo0 (gt of p+1)
        offs = ps - self.lo0
        np.bitwise_or.at(
            packed.reshape(-1), offs >> 3,
            (gt << (offs & 7).astype(np.uint8)).astype(np.uint8))
        self._gt_packed = packed
        self.gt_rows = jnp.asarray(packed)
        self._gt_cap = cap

    # ------------------------------------------------------------- lanes

    def _align(self, starts: np.ndarray, lens: np.ndarray):
        """Row coords + phase alignment (walk starts padded up to
        255 mod 256 positions; the pad steps are masked off).  The
        per-lane coordinate shipped to the kernel is the ABSOLUTE text
        row of the aligned start (int32; < 2^25 at 2^33 symbols) — flat
        symbol offsets would exceed uint32 past 2^32."""
        T = self.lane_bucket
        start_off = starts - self.lo0
        aligned = ((start_off + 1 + 255) // 256) * 256 - 1
        afrom = aligned - start_off
        ato = afrom + lens
        rows = np.zeros(T, np.int32)
        af = np.zeros(T, np.int32)
        at = np.zeros(T, np.int32)
        k = len(starts)
        rows[:k] = (aligned + self.lo0) >> 8
        af[:k] = afrom
        at[:k] = ato
        return rows, af, at, aligned

    def _run_anchor_dev(self, starts: np.ndarray, lbs: np.ndarray,
                        r0_val: int):
        """Contraction pass from one bound; lane j walks positions
        (starts[j], starts[j]+lbs[j]] seeded at r0_val.  Returns the
        DEVICE rank array (no sync) so both bounds' passes overlap."""
        walk_start = starts + lbs
        self._ensure_gt(int(walk_start.max()) + 1)
        rows, af, at, _ = self._align(walk_start, lbs)
        r = jnp.full(self.lane_bucket, np.uint32(r0_val), jnp.uint32)
        max_steps = int(at.max())
        done = 0
        saj = jnp.asarray(rows)
        afj = jnp.asarray(af)
        atj = jnp.asarray(at)
        while done < max_steps:
            outer = chunk_outer(max_steps - done)
            r = _anchor_chunk(outer, self.focc, self.text_rows, self.gt_rows,
                              self.lo0 // TEXT_BLOCK, self.c_first,
                              self.consts, saj, afj, atj, r,
                              jnp.int32(done))
            done += outer * 256
        return r

    def _anchor_materialize(self, r_dev, k: int) -> np.ndarray:
        return np.asarray(r_dev)[:k].astype(np.int64)

    def _run_anchor(self, starts: np.ndarray, lbs: np.ndarray,
                    r0_val: int) -> np.ndarray:
        return self._anchor_materialize(
            self._run_anchor_dev(starts, lbs, r0_val), len(starts))

    def anchor(self, starts: np.ndarray, lookback: int
               ) -> Tuple[np.ndarray, np.ndarray]:
        """R(start_j + 1) by interval contraction over up to `lookback`
        steps; per-lane lookback clamps keep positions <= e-2.  Returns
        (ranks, resolved mask).  Both bounds dispatch before either is
        fetched — one host round trip instead of two."""
        lbs = np.minimum(lookback, (self.e - 2) - starts)
        lbs = np.maximum(lbs, 1)
        lo_d = self._run_anchor_dev(starts, lbs, 0)
        hi_d = self._run_anchor_dev(starts, lbs, self.gap_size)
        k = len(starts)
        if isinstance(lo_d, tuple):   # wide runner: (hi, lo) pairs
            lo = self._anchor_materialize(lo_d, k)
            hi = self._anchor_materialize(hi_d, k)
        else:
            # both bounds in ONE fetch (one host round trip, not two)
            both = np.asarray(jnp.concatenate([lo_d, hi_d]))
            T = lo_d.shape[0]
            lo = both[:k].astype(np.int64)
            hi = both[T : T + k].astype(np.int64)
        return lo, lo == hi

    def run_chains(self, starts: np.ndarray, seeds: np.ndarray,
                   lens: np.ndarray, force_int32: bool = False) -> None:
        """Walk lane j from position starts[j] (seeded with
        R(starts[j]+1) = seeds[j]) for lens[j] steps, recording every new
        R into the device gap histogram and harvesting (pos, R) at
        sample_rate-aligned positions."""
        T = self.lane_bucket
        # 2-D histogram: rank spaces past 2^31 cells exceed the flat
        # per-dimension buffer limit; the sentinel needs one spare row
        assert self.gap_size + 2 <= ((1 << 24) - 1) * 256, \
            "rank space must stay 256 short of 2^32"
        grows = _pad_pow2((self.gap_size + 2 + 255) // 256, lo=4)
        self._samples = []
        gdt = jnp.int32 if force_int32 else self.gap_dtype
        self.gap = jnp.zeros((grows, 256), gdt)
        self._ensure_gt(int(starts.max()) + 1)
        rows, af, at, aligned = self._align(starts, lens)
        r = np.zeros(T, np.uint32)
        r[: len(starts)] = seeds
        r = jnp.asarray(r)
        saj, afj, atj = jnp.asarray(rows), jnp.asarray(af), jnp.asarray(at)
        max_steps = int(at.max())
        rate = self.sample_rate
        aligned_abs = aligned + self.lo0
        phase = (aligned_abs % rate).astype(np.int64) if rate else None
        done = 0
        while done < max_steps:
            outer = chunk_outer(max_steps - done)
            chunklen = outer * 256
            if rate:
                nsamp = chunklen // rate + 1
                k0p = (phase - done) % rate  # first sample step in chunk
                idx = (k0p[None, :] + rate * np.arange(nsamp)[:, None])
                valid = idx < chunklen
                idxc = np.zeros((nsamp, T), np.int32)
                idxc[:, : len(starts)] = np.minimum(idx, chunklen - 1)
            else:
                nsamp = 1
                idxc = np.zeros((1, T), np.int32)
                valid = None
            r, self.gap, samp = _chain_chunk(
                outer, self.focc, self.text_rows, self.gt_rows,
                self.lo0 // TEXT_BLOCK, self.c_first, self.consts,
                saj, afj, atj, self.gap, r, jnp.int32(done),
                jnp.asarray(idxc))
            if rate:
                # keep the harvest on device: fetching here would sync
                # every chunk (one host round trip per chunk);
                # harvest_samples materializes them after the last chunk
                self._samples.append((done, samp, valid))
            done += chunklen
        self.final_rs = np.asarray(r)[: len(starts)].astype(np.int64)
        self._lanes = (starts.copy(), lens.copy(), aligned_abs.copy(),
                       af[: len(starts)].copy(), at[: len(starts)].copy())

    # ------------------------------------------------------------ results

    def gap_checksum(self) -> int:
        # explicit u32 accumulator: the u16 histogram must not also wrap
        # the reduction (block_len < 2^32, so u32 is exact); cells past
        # gap_size are never written (sentinel rows drop)
        return int(jnp.sum(self.gap, dtype=jnp.uint32))

    def _materialize_samples(self) -> None:
        """Fetch every chunk's on-device sample buffer in ONE host
        round trip (a per-chunk np.asarray loop pays one round trip per
        chunk — a 3.2 Gbp root merge has ~16 chunks)."""
        devs = [s for _d, s, _v in self._samples
                if not isinstance(s, np.ndarray)]
        if not devs:
            return
        host = np.asarray(devs[0]) if len(devs) == 1 else \
            np.asarray(jnp.concatenate(devs, axis=0))
        off = 0
        out = []
        for done, s, valid in self._samples:
            if isinstance(s, np.ndarray):
                out.append((done, s, valid))
            else:
                k = s.shape[0]
                out.append((done, host[off : off + k], valid))
                off += k
        self._samples = out

    def harvest_samples(self) -> Tuple[np.ndarray, np.ndarray]:
        """(positions, R values) at sample_rate-aligned positions."""
        if not self.sample_rate:
            return np.zeros(0, np.int64), np.zeros(0, np.int64)
        starts, lens, aligned_abs, af, at = self._lanes
        self._materialize_samples()
        pos_all, val_all = [], []
        for done, samp, valid in self._samples:
            samp = samp[:, : len(starts)]
            nsamp, k = samp.shape
            ks = ((aligned_abs % self.sample_rate - done) % self.sample_rate)[
                None, :] + self.sample_rate * np.arange(nsamp)[:, None] + done
            p = aligned_abs[None, :] - ks
            ok = (ks >= af[None, :]) & (ks < at[None, :]) & valid
            pos_all.append(p[ok])
            val_all.append(samp[ok])
        pos = np.concatenate(pos_all) if pos_all else np.zeros(0, np.int64)
        val = np.concatenate(val_all).astype(np.int64) if val_all else \
            np.zeros(0, np.int64)
        order = np.argsort(pos)
        return pos[order], val[order]

    def fetch_gap_compressed(self):
        """(gap8, ov_idx, ov_val): byte histogram with 255 = overflow.
        Overflow candidates are found on HOST from the fetched bytes
        (a device flatnonzero over a 2^31+-cell histogram would need the
        flat view that big buffers cannot take); their exact values come
        back through one small 2-index device gather."""
        from .idx64 import take2d_u32
        G = self.gap_size + 1
        g8 = np.asarray(
            jnp.minimum(self.gap, 255).astype(jnp.uint8)).reshape(-1)[:G]
        ov_idx_np = np.flatnonzero(g8 == 255).astype(np.int64)
        if len(ov_idx_np):
            rows = (ov_idx_np >> 8).astype(np.uint32)
            cols = (ov_idx_np & 255).astype(np.uint32)
            ov_val_np = np.asarray(
                take2d_u32(self.gap, jnp.asarray(rows), jnp.asarray(cols)),
                dtype=np.int64)
        else:
            ov_val_np = np.zeros(0, np.int64)
        return g8, ov_idx_np, ov_val_np

    def cnt_le_at_host(self, ranks: np.ndarray, gap8: np.ndarray,
                       ov_idx: np.ndarray, ov_val: np.ndarray) -> np.ndarray:
        return cnt_le_from_gap(ranks, gap8, ov_idx, ov_val)


def cnt_le_from_gap(ranks: np.ndarray, gap8: np.ndarray,
                    ov_idx: np.ndarray, ov_val: np.ndarray) -> np.ndarray:
    """cnt_le[r] = #left suffixes with R <= r at the given (sorted or
    unsorted) ranks, computed on host from the byte-compressed gap —
    a device cumsum over the full rank space is a 6.4 GB int32
    transient at a 1.6 G root merge; np.add.reduceat over the sample
    segments costs O(|gap| + #ranks) with no large temporary."""
    if len(ranks) == 0:
        return np.zeros(0, np.int64)
    order = np.argsort(ranks, kind="stable")
    r_sorted = ranks[order].astype(np.int64)
    # segment sums gap8[bounds[i]:bounds[i+1]); a trailing 0 sentinel
    # keeps every reduceat index in range (bounds[-1] may equal
    # len(gap8)), and zero-length segments (duplicate ranks), where
    # reduceat returns the start element instead of 0, are masked
    g = np.concatenate([np.asarray(gap8, np.uint8), np.zeros(1, np.uint8)])
    bounds = np.concatenate([[0], r_sorted + 1])
    sums = np.add.reduceat(g, bounds, dtype=np.int64)[:-1]
    sums = np.where(np.diff(bounds) > 0, sums, 0)
    cnt_sorted = np.cumsum(sums)
    # overflow corrections: gap8 saturates at 255; add the surplus of
    # every overflowed rank <= r
    if len(ov_idx):
        surplus = (ov_val - 255).astype(np.int64)
        pos = np.searchsorted(ov_idx, r_sorted, side="right")
        cs = np.concatenate([[0], np.cumsum(surplus)])
        cnt_sorted = cnt_sorted + cs[pos]
    out = np.empty(len(ranks), np.int64)
    out[order] = cnt_sorted
    return out

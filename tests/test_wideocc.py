"""Two-word (hi, lo) rank path (ops/wideocc.py) for texts past 2^32.

A real 4 G-symbol build cannot run under CPU tests, so the wide path is
pinned against a DOCTORED structure: build a small fused rank structure,
then add a per-symbol 64-bit base offset B[c] close to 2^32 to every
stored occ checkpoint lo word (uint32 wrap-around), exactly as if the
small BWT were the tail of a huge text with B[c] prior occurrences of
each symbol.  The wrap-threshold recovery (find_wrap_rows), the derived
hi words, the carry discipline and the wide C array are all checked
against plain int64 ground truth.
"""

import numpy as np
import pytest

jnp = pytest.importorskip("jax.numpy")

from bwtb3m.ops.focc import FusedOcc
from bwtb3m.ops.focc_bp import NPLANES, FusedOccBP
from bwtb3m.ops.focc_build import build_focc_host
from bwtb3m.ops.wideocc import (
    WideOcc, access_batch_w, find_wrap_rows, lf_step_batch_w,
    rank_batch_w, row_of, widen_focc)

TWO32 = 1 << 32


def _true_occ64(bwt: np.ndarray, sigma: int) -> np.ndarray:
    """Exclusive per-block-row occ checkpoints, int64 [nb + 1, sigma]."""
    n = len(bwt)
    nb = (n + 255) // 256
    pad = np.full(nb * 256 - n, -1, np.int64)
    blocks = np.concatenate([bwt.astype(np.int64), pad]).reshape(nb, 256)
    per = np.stack([(blocks == c).sum(axis=1) for c in range(sigma)], 1)
    occ = np.zeros((nb + 1, sigma), np.int64)
    occ[1:] = np.cumsum(per, axis=0)
    return occ


def _doctor(focc, B: np.ndarray):
    """Add B[c] (mod 2^32) to every stored occ checkpoint of symbol c."""
    sigma = focc.sigma
    rows = np.asarray(focc.rows)
    if isinstance(focc, FusedOccBP):
        words = rows.reshape(rows.shape[0], 32, 4).view(np.uint32).copy()
        w = words.reshape(rows.shape[0], 32)
        w[:, NPLANES * 8 : NPLANES * 8 + sigma] += B.astype(np.uint32)
        new = w.view(np.uint8).reshape(rows.shape).view(np.int8)
        return FusedOccBP(jnp.asarray(new), focc.C, focc.n, sigma)
    block = focc.block
    cw = rows[:, block : block + 4 * sigma].copy()
    w = cw.reshape(rows.shape[0], sigma, 4).view(np.uint32).reshape(
        rows.shape[0], sigma)
    w += B.astype(np.uint32)
    rows = rows.copy()
    rows[:, block : block + 4 * sigma] = w.view(np.uint8).reshape(
        rows.shape[0], 4 * sigma).view(np.int8)
    return FusedOcc(jnp.asarray(rows), focc.C, focc.n, sigma, block)


def _make_wide(sigma: int, n: int, seed: int, chunk: int):
    rng = np.random.default_rng(seed)
    bwt = rng.integers(0, sigma, n).astype(np.uint8)
    focc, bases, g = build_focc_host(bwt, sigma, chunk_rows=chunk,
                                     return_bases=True)
    occ64 = _true_occ64(bwt, sigma)
    nb = (n + 255) // 256
    # wrap rows spread over (g, nb), one per symbol; B[c] + occ crosses
    # 2^32 inside the structure (also exercises an exact-boundary wrap
    # for c == 0: stored checkpoint becomes exactly 0).  Rows stay past
    # the first chunk: find_wrap_rows' base row is a hard occ[0] == 0
    # (true in real builds — one chunk cannot accumulate 2^32 counts),
    # which the doctored prefix-offset structure does not satisfy.
    B = np.zeros(sigma, np.uint64)
    for c in range(sigma):
        r = g + 1 + (c + 1) * (nb - g - 1) // (sigma + 1)
        B[c] = np.uint64(TWO32 - int(occ64[r, c]) - (0 if c == 0 else c))
    wfocc = _doctor(focc, B.astype(np.uint32))
    dbases = (bases.astype(np.uint64) + B[None, :]).astype(np.uint32)
    w = widen_focc(wfocc, dbases, g, int(B.sum()) + n)
    totals = B + occ64[nb].astype(np.uint64)
    Cw = np.zeros(sigma + 1, np.uint64)
    Cw[1:] = np.cumsum(totals)
    return bwt, w, occ64, B, Cw


@pytest.mark.parametrize("sigma,chunk", [(5, 64), (12, 128)])
def test_wide_rank_straddles_2_32(sigma, chunk):
    n = 256 * 1024 + 173
    bwt, w, occ64, B, _ = _make_wide(sigma, n, 11, chunk)
    rng = np.random.default_rng(1)
    i = rng.integers(0, n + 1, 1024).astype(np.uint32)
    c = rng.integers(0, sigma, 1024).astype(np.int32)
    hi, lo = rank_batch_w(w, jnp.asarray(c), jnp.zeros(1024, jnp.uint32),
                          jnp.asarray(i))
    # int64 ground truth: B[c] + true rank
    tr = occ64[i >> 8, c] + np.array(
        [(bwt[(int(p) >> 8) * 256 : int(p)] == cc).sum()
         for p, cc in zip(i, c)], np.int64)
    want = B[c] + tr.astype(np.uint64)
    got = (np.asarray(hi).astype(np.uint64) << np.uint64(32)) \
        | np.asarray(lo).astype(np.uint64)
    assert np.array_equal(got, want)


def test_wide_access_and_lf():
    sigma, n = 5, 256 * 512 + 55
    bwt, w, occ64, B, Cw = _make_wide(sigma, n, 7, 32)
    rng = np.random.default_rng(2)
    i = rng.integers(0, n, 2048).astype(np.uint32)
    sym = np.asarray(access_batch_w(
        w, jnp.zeros(2048, jnp.uint32), jnp.asarray(i)))
    assert np.array_equal(sym, bwt[i].astype(sym.dtype))
    s2, hi, lo = lf_step_batch_w(
        w, jnp.zeros(2048, jnp.uint32), jnp.asarray(i))
    assert np.array_equal(np.asarray(s2), bwt[i].astype(np.int32))
    tr = occ64[i >> 8, bwt[i]] + np.array(
        [(bwt[(int(p) >> 8) * 256 : int(p)] == bwt[p]).sum() for p in i],
        np.int64)
    want = Cw[bwt[i]] + B[bwt[i]] + tr.astype(np.uint64)
    got = (np.asarray(hi).astype(np.uint64) << np.uint64(32)) \
        | np.asarray(lo).astype(np.uint64)
    assert np.array_equal(got, want)


def test_wide_c_array():
    sigma, n = 5, 256 * 300
    _, w, occ64, B, Cw = _make_wide(sigma, n, 3, 64)
    got = (np.asarray(w.C_hi).astype(np.uint64) << np.uint64(32)) \
        | np.asarray(w.focc.C).astype(np.uint64)
    assert np.array_equal(got, Cw)


def test_find_wrap_rows_no_wraps():
    rng = np.random.default_rng(5)
    bwt = rng.integers(0, 5, 70_000).astype(np.uint8)
    focc, bases, g = build_focc_host(bwt, 5, chunk_rows=32,
                                     return_bases=True)
    nb = (len(bwt) + 255) // 256
    thr = find_wrap_rows(focc, bases, g, nb)
    assert (thr == 0xFFFFFFFF).all()


def test_row_of_arithmetic():
    rng = np.random.default_rng(9)
    pos = rng.integers(0, 1 << 39, 4096).astype(np.uint64)
    hi = (pos >> np.uint64(32)).astype(np.uint32)
    lo = (pos & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    row = np.asarray(row_of(jnp.asarray(hi), jnp.asarray(lo)))
    assert np.array_equal(row.astype(np.int64), (pos >> np.uint64(8)))


def test_check_bwt_wide_kernel(tmp_path, monkeypatch):
    # BWTB3M_FORCE_WIDE drives check_bwt through the (hi, lo) wide walk
    # kernel (_verify_chunk_w) on a small text: hi words are all zero, so
    # the result must match the narrow path — including catching a
    # corrupted BWT. (The wrap arithmetic itself is pinned by the
    # straddle tests above; this pins the engine plumbing.)
    from bwtb3m.engine import BwtOptions, check_bwt, compute_bwt
    from bwtb3m.io import rl

    rng = np.random.default_rng(17)
    data = bytes(rng.integers(97, 102, size=4096, dtype=np.uint8))
    inp = str(tmp_path / "t.bin")
    open(inp, "wb").write(data)
    res = compute_bwt(BwtOptions(input_path=inp, preisa_sampling_rate=256,
                                 verbose=0))
    text = np.frombuffer(data, np.uint8).astype(np.int32)
    monkeypatch.setenv("BWTB3M_FORCE_WIDE", "1")
    from bwtb3m.ops.wideocc import WideOcc
    focc, _ = res.load_focc(dense=True)
    assert isinstance(focc, WideOcc)
    assert check_bwt(res, text)
    bwt = res.load_bwt()
    i = int(np.flatnonzero(bwt[1:] != bwt[:-1])[0])
    bwt[i], bwt[i + 1] = bwt[i + 1], bwt[i]
    rl.rl_encode(res.bwt_path, bwt, sigma=res.sigma)
    assert not check_bwt(res, text)


def test_compute_ssa_wide_kernel(tmp_path, monkeypatch):
    # the wide harvest (two-word lanes, borrow/carry position math, split
    # sa planes) must reproduce the narrow path's .sa/.isa exactly
    from bwtb3m.engine import BwtOptions, compute_bwt, compute_ssa
    from bwtb3m.io import formats

    rng = np.random.default_rng(23)
    data = bytes(rng.integers(97, 101, size=8192, dtype=np.uint8))
    inp = str(tmp_path / "t.bin")
    open(inp, "wb").write(data)
    res = compute_bwt(BwtOptions(input_path=inp, bwt_only=True,
                                 preisa_sampling_rate=512, verbose=0))
    sa_n, isa_n = compute_ssa(res.bwt_path, 32, 64)
    rate_sa, vals_sa = formats.read_sampled_array(sa_n)
    rate_isa, vals_isa = formats.read_sampled_array(isa_n)
    monkeypatch.setenv("BWTB3M_FORCE_WIDE", "1")
    sa_w, isa_w = compute_ssa(res.bwt_path, 32, 64)
    rate_sa2, vals_sa2 = formats.read_sampled_array(sa_w)
    rate_isa2, vals_isa2 = formats.read_sampled_array(isa_w)
    assert rate_sa2 == rate_sa and rate_isa2 == rate_isa
    assert np.array_equal(vals_sa2, vals_sa)
    assert np.array_equal(vals_isa2, vals_isa)


def test_compute_isa_wide_kernel(tmp_path, monkeypatch):
    from bwtb3m.engine import BwtOptions, compute_bwt
    from bwtb3m.engine.ssa import compute_isa_from_preisa
    from bwtb3m.io import formats

    rng = np.random.default_rng(29)
    data = bytes(rng.integers(97, 103, size=5000, dtype=np.uint8))
    inp = str(tmp_path / "t.bin")
    open(inp, "wb").write(data)
    res = compute_bwt(BwtOptions(input_path=inp, bwt_only=True,
                                 preisa_sampling_rate=256, verbose=0))
    isa_n = compute_isa_from_preisa(res.bwt_path, 64)
    _r, vals_n = formats.read_sampled_array(isa_n)
    monkeypatch.setenv("BWTB3M_FORCE_WIDE", "1")
    isa_w = compute_isa_from_preisa(res.bwt_path, 64)
    _r, vals_w = formats.read_sampled_array(isa_w)
    assert np.array_equal(vals_w, vals_n)

"""Durable merge-tree checkpointing (engine/checkpoint.py): a build
killed between merges resumes from the saved regions to a bit-identical
result (the reference's tmpprefix restartability,
/root/reference/src/bwtb3m.cpp:52-53, checkbwt.cpp:24)."""

import os

import numpy as np
import pytest

from bwtb3m.engine.options import BwtOptions
from bwtb3m.engine.merge_scaled import blockwise_bwt_scaled
from bwtb3m.util.log import VerboseLog


def _opts(tmp_path, tag, **kw):
    kw.setdefault("checkpoint", True)
    return BwtOptions(input_path="x",
                      output_filename=str(tmp_path / (tag + ".bwt")),
                      max_block_symbols=1024, batch_merges=False,
                      checkpoint_min_symbols=1, **kw)


def _regfiles(opts):
    import glob
    return sorted(glob.glob(opts.tmp_prefix + "_BWTREG1_reg_*.npz"))


def test_kill_and_resume_bit_identical(tmp_path, monkeypatch):
    import bwtb3m.engine.merge_scaled as ms

    rng = np.random.default_rng(31)
    n = 7000                      # 7 blocks -> 6 merges over 3 levels
    text = rng.integers(0, 4, n).astype(np.int32)

    ref_opts = _opts(tmp_path, "ref", checkpoint=False)
    want = blockwise_bwt_scaled(text, 4, ref_opts, VerboseLog(0),
                                sample_rate=256, lane_bucket=32)

    opts = _opts(tmp_path, "run")
    real_merge = ms._merge_pair_scaled
    calls = {"n": 0}

    def dying_merge(ctx, l, r):
        if calls["n"] == 2:       # kill between merge 2 and 3 of level 0
            raise RuntimeError("simulated crash")
        calls["n"] += 1
        return real_merge(ctx, l, r)

    monkeypatch.setattr(ms, "_merge_pair_scaled", dying_merge)
    monkeypatch.setenv("BWTB3M_CKPT_SYNC", "1")
    with pytest.raises(RuntimeError, match="simulated crash"):
        blockwise_bwt_scaled(text, 4, opts, VerboseLog(0),
                             sample_rate=256, lane_bucket=32)
    saved = _regfiles(opts)
    assert len(saved) == 2, saved   # the two completed level-0 merges

    calls2 = {"n": 0}

    def counting_merge(ctx, l, r):
        calls2["n"] += 1
        return real_merge(ctx, l, r)

    monkeypatch.setattr(ms, "_merge_pair_scaled", counting_merge)
    got = blockwise_bwt_scaled(text, 4, opts, VerboseLog(0),
                               sample_rate=256, lane_bucket=32)
    # 6 merges total; 2 resumed from checkpoint files
    assert calls2["n"] == 4
    for w, g in zip(want, got):
        assert np.array_equal(w, g)
    assert _regfiles(opts) == []    # cleaned after success


def test_stale_key_ignored(tmp_path, monkeypatch):
    """Checkpoints from a DIFFERENT text must not resume into a build."""
    import bwtb3m.engine.merge_scaled as ms

    monkeypatch.setenv("BWTB3M_CKPT_SYNC", "1")
    rng = np.random.default_rng(7)
    n = 4000
    text1 = rng.integers(0, 4, n).astype(np.int32)
    text2 = rng.integers(0, 4, n).astype(np.int32)
    opts = _opts(tmp_path, "stale")
    real_merge = ms._merge_pair_scaled

    def dying_merge(ctx, l, r):
        dying_merge.k += 1
        if dying_merge.k > 1:
            raise RuntimeError("boom")
        return real_merge(ctx, l, r)

    dying_merge.k = 0
    monkeypatch.setattr(ms, "_merge_pair_scaled", dying_merge)
    with pytest.raises(RuntimeError):
        blockwise_bwt_scaled(text1, 4, opts, VerboseLog(0),
                             sample_rate=256, lane_bucket=32)
    assert _regfiles(opts)
    monkeypatch.setattr(ms, "_merge_pair_scaled", real_merge)
    # different text, same tmp prefix: saved regions must be ignored
    got = blockwise_bwt_scaled(text2, 4, opts, VerboseLog(0),
                               sample_rate=256, lane_bucket=32)
    ref = blockwise_bwt_scaled(
        text2, 4, _opts(tmp_path, "stale_ref", checkpoint=False),
        VerboseLog(0), sample_rate=256, lane_bucket=32)
    for w, g in zip(ref, got):
        assert np.array_equal(w, g)


def test_hostmem_text_spill(tmp_path):
    """hostmem= below 2n forces the text onto a read-only memmap under
    tmp_prefix; output identical, spill file removed afterwards."""
    import glob

    from bwtb3m.engine import BwtOptions as BO, compute_bwt

    rng = np.random.default_rng(4)
    data = rng.integers(97, 101, 6000, dtype=np.uint8)
    inp = str(tmp_path / "h.bin")
    data.tofile(inp)
    kw = dict(input_path=inp, engine="merge", bwt_only=True,
              max_block_symbols=2048, preisa_sampling_rate=256, verbose=0,
              lane_bucket=32)
    res_ref = compute_bwt(BO(output_filename=str(tmp_path / "a.bwt"),
                             **kw))
    res_sp = compute_bwt(BO(output_filename=str(tmp_path / "b.bwt"),
                            host_mem=1000, **kw))
    np.testing.assert_array_equal(res_ref.load_bwt(), res_sp.load_bwt())
    assert glob.glob(str(tmp_path / "*_text.u8")) == []


def test_bounded_ingestion_memmap_load(tmp_path, monkeypatch):
    """hostmem=: the text loads as a read-only memmap without a full
    in-RAM transient — bytestream maps the input
    file zero-copy; pacterm decodes chunk-by-chunk into a spill that is
    removed after the build; outputs identical to the unbounded path."""
    import glob

    from bwtb3m.engine import BwtOptions as BO, compute_bwt
    from bwtb3m.io.inputtypes import parse_input_type
    from bwtb3m.io.pac import write_pac

    # loader-level: bytestream is zero-copy; full .load never called
    rng = np.random.default_rng(8)
    data = rng.integers(65, 69, 5000, dtype=np.uint8)
    inp = str(tmp_path / "m.bin")
    data.tofile(inp)
    bt = parse_input_type("bytestream")
    with monkeypatch.context() as m:
        m.setattr(bt, "load",
                  staticmethod(lambda p: (_ for _ in ()).throw(
                      AssertionError("full load called"))))
        syms, sigma, spill = bt.load_bounded(inp, str(tmp_path / "s.u8"))
    assert isinstance(syms, np.memmap) and spill is None and sigma == 256
    np.testing.assert_array_equal(np.asarray(syms), data)

    # pacterm chunked decode matches the full loader
    codes = rng.integers(0, 4, 4097, dtype=np.uint8)
    pacp = str(tmp_path / "g.pac")
    write_pac(pacp, codes)
    pt = parse_input_type("pacterm")
    full, fsigma = pt.load(pacp)
    syms, sigma, spill = pt.load_bounded(pacp, str(tmp_path / "p.u8"))
    assert sigma == fsigma == 5 and isinstance(syms, np.memmap)
    np.testing.assert_array_equal(np.asarray(syms), full)

    # engine-level: bounded build == unbounded build, spills cleaned up
    kw = dict(input_path=inp, engine="merge", bwt_only=True,
              max_block_symbols=2048, preisa_sampling_rate=256,
              verbose=0, lane_bucket=32)
    ref = compute_bwt(BO(output_filename=str(tmp_path / "u.bwt"), **kw))
    got = compute_bwt(BO(output_filename=str(tmp_path / "b.bwt"),
                         host_mem=1000, **kw))
    np.testing.assert_array_equal(ref.load_bwt(), got.load_bwt())
    assert glob.glob(str(tmp_path / "*_text*.u8")) == []


def test_backlog_cap_and_forced_root_children(tmp_path, monkeypatch):
    """Byte-sized backlog cap: with slow downloads
    and a tiny pending-bytes budget, non-forced offers are skipped with
    a WARNING — but a skipped span stays re-offerable, and the engine's
    force+drain ahead of the root merge persists both children."""
    import time

    from bwtb3m.engine.checkpoint import (MergeCheckpointer,
                                              region_path)

    monkeypatch.setenv("BWTB3M_CKPT_PENDING_BYTES", "1")
    warns = []

    class WLog:
        def v(self, msg, level=1):
            pass

        def w(self, msg):
            warns.append(msg)

    class Reg:
        def __init__(self, s, e):
            self.s, self.e = s, e
            self.samp_pos = np.zeros(0, np.int64)
            self.samp_rank = np.zeros(0, np.int64)
            self.r_start = 0
            self.hist = np.zeros(4, np.int64)

    ck = MergeCheckpointer(str(tmp_path / "t"), "k", bits=8,
                           min_symbols=1, log=WLog())

    def slow_get(reg):
        def get():
            time.sleep(0.2)  # a long device download, scaled down
            return np.zeros(reg.e - reg.s, np.uint8)
        return get

    regs = [Reg(i * 100, (i + 1) * 100) for i in range(4)]
    for r in regs:
        ck.offer(r, slow_get(r))
    # first offer submitted; the rest skipped at warning level
    assert len(warns) >= 2
    # root children: force bypasses the cap, drain persists them
    kids = [Reg(0, 200), Reg(200, 400)]
    for r in kids:
        ck.offer(r, slow_get(r), force=True)
    ck.drain()
    for r in kids:
        assert os.path.exists(region_path(str(tmp_path / "t"), "k",
                                          r.s, r.e))
    # a previously skipped span is re-offerable once the backlog clears
    ck.offer(regs[1], slow_get(regs[1]))
    ck.drain()
    assert os.path.exists(region_path(str(tmp_path / "t"), "k", 100, 200))
    ck.finish(True)
    import glob
    assert glob.glob(str(tmp_path / "t") + "_BWTREG1_reg_*.npz") == []


def test_async_offer_and_batched_level(tmp_path):
    """Default async saves + batched levels: files appear, result is
    identical, and success cleans up."""
    rng = np.random.default_rng(13)
    n = 8192
    text = rng.integers(0, 4, n).astype(np.int32)
    opts = BwtOptions(input_path="x",
                      output_filename=str(tmp_path / "b.bwt"),
                      max_block_symbols=1024, checkpoint=True,
                      checkpoint_min_symbols=1)
    got = blockwise_bwt_scaled(text, 4, opts, VerboseLog(0),
                               sample_rate=256, lane_bucket=32)
    ref = blockwise_bwt_scaled(
        text, 4, BwtOptions(input_path="x",
                            output_filename=str(tmp_path / "br.bwt"),
                            max_block_symbols=1024, checkpoint=False),
        VerboseLog(0), sample_rate=256, lane_bucket=32)
    for w, g in zip(ref, got):
        assert np.array_equal(w, g)
    assert _regfiles(opts) == []

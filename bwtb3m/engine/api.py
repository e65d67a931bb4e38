"""Top-level BWT construction — equivalent of ``BwtMergeSort::computeBwt``.

The reference's entry point (/root/reference/src/bwtb3m.cpp:62-63) runs:
block plan -> per-block divsufsort -> balanced gap-array merge tree ->
.bwt/.hist/.meta/.preisa (+ .sa/.isa when bwtonly=0). This rebuild replaces
phases 2-3 with the on-device circular prefix-doubling sorter
(``ops/doubling.py``); the blockwise gap-merge engine for texts beyond a
single device's HBM lives in ``engine/merge.py``. Phase structure and the
emitted file set match the reference (README "Output").
"""

from __future__ import annotations

import os
import sys
from typing import Optional

import numpy as np

from ..io import formats
from ..io.inputtypes import parse_input_type
from ..io.rl import rl_encode
from ..ops.doubling import suffix_array
from ..util.log import RealTimeClock, VerboseLog, mem_usage_string
from .options import BwtOptions
from .result import BwtResult


def _spill_text(symbols: np.ndarray, options: BwtOptions,
                log: VerboseLog):
    """Bounded host memory (reference: the mem= semi-external
    discipline, /root/reference/src/bwtb3m.cpp:47): when ``hostmem=`` is
    set and text + final BWT would exceed it, the text moves to a
    read-only memmap under tmp_prefix — the engine (gt comparator, text
    packing, block histograms) reads it page-by-page, so resident set
    stays bounded by the page cache, which the kernel reclaims under
    pressure.  Returns (symbols, spill_path or None)."""
    hostmem = getattr(options, "host_mem", None)
    n = len(symbols)
    if isinstance(symbols, np.memmap):
        return symbols, None   # already bounded (load_bounded)
    if not hostmem or 2 * n <= hostmem:
        return symbols, None
    path = options.tmp_prefix + "_text.u8"
    np.asarray(symbols, np.uint8).tofile(path)
    log.v("hostmem=%d: text (%d bytes) spilled to memmap %s"
          % (hostmem, n, path))
    return np.memmap(path, np.uint8, "r"), path


def compute_bwt(options: BwtOptions, log: Optional[VerboseLog] = None) -> BwtResult:
    log = log or VerboseLog(options.verbose)
    rtc = RealTimeClock()

    # ---- phase 1: load input + plan ------------------------------------
    itype = parse_input_type(options.input_type)
    bounded_spill = None
    with log.span("load input (%s)" % itype.name):
        if getattr(options, "host_mem", None):
            # hostmem=: the text never fully materializes in RAM — packed
            # formats decode chunk-by-chunk into a read-only memmap, a
            # bytestream maps the input file directly (the reference's
            # streaming default; copyinputtomemory is the opt-in,
            # /root/reference/src/bwtb3m.cpp:54)
            symbols, sigma, bounded_spill = itype.load_bounded(
                options.input_path, options.tmp_prefix + "_text.u8")
        else:
            symbols, sigma = itype.load(options.input_path)
    n = int(len(symbols))
    if n == 0:
        raise ValueError("empty input text: %s" % options.input_path)
    log.v("n=%d sigma=%d" % (n, sigma))

    # preisa rate decides both the .preisa output and, for the scaled
    # engine, the in-flight sample harvesting — fix it before sorting
    prate = options.preisa_sampling_rate
    if prate is None:
        # adaptive: ~128k walk lanes, power-of-two, within [32, isa rate]
        target = max(1, n // (1 << 17))
        prate = 1 << max(5, (target - 1).bit_length())
        prate = min(prate, max(32, options.isa_sampling_rate))
    prate = max(1, min(prate, n))

    # ---- phase 2+3: suffix sort (device) -------------------------------
    sa = isa = None
    rows_out = None  # filled by the scaled engine when rows stay in HBM
    symmap = None    # dense-id -> original symbol (alphabet compaction)
    if options.engine == "sharded":
        import jax

        from ..parallel import make_mesh, sharded_bwt
        d = len(jax.devices())  # ragged n handled by pad slots
        with log.span("device suffix sort (sharded, %d devices)" % d):
            sa, _rank, bwt = sharded_bwt(symbols, sigma, make_mesh(d))
            isa = np.zeros(n, dtype=np.int64)
            isa[sa] = np.arange(n, dtype=np.int64)
    elif (options.engine in ("merge", "merge-legacy")
          or (options.engine == "auto" and n > options.max_block_symbols)):
        # rank-compact sparse alphabets to their distinct symbols — the
        # reference's alphabet-compaction pass
        # (/root/reference/src/lcpbit.cpp:677-806).  A strictly monotonic
        # symbol remap preserves rotation order, so the BWT maps back
        # through the same table.  Two cases: sigma > 256 (utf-8
        # codepoints) must compact to run at all; byte alphabets with
        # <= 16 distinct symbols (DNA in a bytestream) compact because
        # nibble-packed device rows halve every text/rank transfer and
        # the merge tree's device-memory footprint.
        if options.engine != "merge-legacy" and sigma > 256:
            uniq = np.unique(np.asarray(symbols))
            if len(uniq) <= 256:
                symmap = uniq
                symbols = np.searchsorted(uniq, np.asarray(symbols)).astype(
                    np.uint8)
                log.v("alphabet rank-compacted: %d distinct symbols"
                      % len(uniq))
        elif options.engine != "merge-legacy" and sigma > 16:
            with log.span("alphabet compaction scan"):
                from .. import native
                syms_np = np.asarray(symbols)
                hist0 = native.byte_hist(syms_np, minlength=sigma)
                uniq = np.flatnonzero(hist0)
                if 0 < len(uniq) <= 16:
                    table = np.zeros(sigma, np.uint8)
                    table[uniq] = np.arange(len(uniq), dtype=np.uint8)
                    symmap = uniq.astype(np.int64)
                    if isinstance(symbols, np.memmap):
                        # bounded mode: rewrite chunk-by-chunk into a
                        # second memmap (a full fancy-index would stage
                        # the whole text in RAM)
                        cpath = options.tmp_prefix + "_text_c.u8"
                        out = np.memmap(cpath, np.uint8, mode="w+",
                                        shape=symbols.shape)
                        for a in range(0, n, 1 << 26):
                            b = min(n, a + (1 << 26))
                            out[a:b] = table[symbols[a:b]]
                        out.flush()
                        del out
                        if bounded_spill:
                            try:
                                os.remove(bounded_spill)
                            except OSError:
                                pass
                        bounded_spill = cpath
                        symbols = np.memmap(cpath, np.uint8, mode="r")
                    else:
                        symbols = table[syms_np]
                    log.v("alphabet rank-compacted: %d distinct symbols"
                          % len(uniq))
        if options.engine != "merge-legacy" and (sigma <= 256
                                                 or symmap is not None):
            # scaled engine: regions carry only BWT + samples (no full
            # SA/ISA), device-resident chains — the path that reaches
            # reference scale (>2^31 symbols, bounded host memory)
            from .merge_scaled import blockwise_bwt_scaled
            eff_sigma = sigma if symmap is None else len(symmap)
            symbols, spill_path = _spill_text(symbols, options, log)
            # the hand-off carries the engine's dense symbols plus the
            # symmap back to file symbols (engine/result.py serves both)
            rows_out = []
            try:
                lb = getattr(options, "lane_bucket", None) or (1 << 16)
                with log.span(
                        "device suffix sort (scaled blockwise merge)"):
                    bwt, spos, srank, _hist = blockwise_bwt_scaled(
                        symbols, eff_sigma, options, log,
                        sample_rate=prate, lane_bucket=lb,
                        rows_out=rows_out)
            finally:
                for p in (spill_path, bounded_spill):
                    if p:
                        symbols = None
                        try:
                            os.remove(p)
                        except OSError:
                            pass
                bounded_spill = None
            # bwt stays uint8 — at 3.2G an int32 copy is 12.8 GB of host
            # RAM for nothing (the codecs and bincount take uint8)
            if symmap is not None:
                # back to original symbols — gather through a table of
                # the narrowest dtype (an int64 fancy-index would stage
                # 8 B/symbol of host transient at 3.2G)
                with log.span("symmap restore"):
                    tab = symmap.astype(
                        np.uint8 if int(symmap.max()) < 256 else np.int32)
                    bwt = tab[bwt]
        else:
            from .merge import blockwise_bwt  # legacy full-SA path
            with log.span("device suffix sort (blockwise merge)"):
                sa, isa, bwt = blockwise_bwt(symbols, sigma, options, log)
    else:
        with log.span("device suffix sort (single block, prefix doubling)"):
            sa, isa, bwt = suffix_array(symbols, sigma)

    # ---- phase 4: outputs ----------------------------------------------
    base = options.base_name
    files = {}
    with log.span("write .bwt (%s)" % options.bwt_codec):
        if options.bwt_codec == "rlh":
            from ..io.rlh import rlh_encode
            rlh_encode(options.output_filename, bwt, sigma=sigma)
        else:
            rl_encode(options.output_filename, bwt, sigma=sigma)
        files["bwt"] = options.output_filename

    with log.span("output hist"):
        if bwt.dtype == np.uint8:
            from .. import native
            h256 = native.byte_hist(bwt)
            nz = np.flatnonzero(h256)
            top = int(nz[-1]) + 1 if len(nz) else 0
            hist = h256[: max(sigma, top)]  # bincount length semantics
        else:
            hist = np.bincount(bwt, minlength=sigma).astype(np.int64)

    # device-rows hand-off: bind the final region's HBM rows to the .bwt
    # just written so an in-process checkbwt/ssa skips the re-upload.
    # The handle carries the build's identity (n, sigma, histogram) and
    # register_device_rows verifies it against this .bwt's stats before
    # binding — a handle from a different build is refused, not bound
    # (reference role: the freshness-checked .hwt reuse,
    # /root/reference/src/checkbwt.cpp:46-53).
    rows_handle = rows_out or None
    if rows_handle:
        from .result import register_device_rows
        try:
            register_device_rows(options.output_filename, rows_handle[0],
                                 n, sigma, hist, symmap=symmap)
        except Exception as exc:  # hand-off is an optimization, not a gate
            log.v("[W] device-rows hand-off skipped: %s" % exc)
    formats.write_hist(base + ".hist", formats.hist_from_array(hist))
    files["hist"] = base + ".hist"

    if isa is not None:
        spos = np.arange(0, n, prate, dtype=np.int64)
        srank = isa[spos]
    formats.write_preisa(base + ".preisa", srank, spos, prate)
    files["preisa"] = base + ".preisa"

    def write_meta():
        meta = {
            "format": "bwtb3m/v1",
            "n": n,
            "sigma": sigma,
            "input": os.path.abspath(options.input_path),
            "inputtype": itype.name,
            "bwtonly": bool(options.bwt_only),
            "sasamplingrate": options.sa_sampling_rate,
            "isasamplingrate": options.isa_sampling_rate,
            "preisasamplingrate": prate,
            "files": files,
        }
        formats.write_meta(base + ".meta", meta)
        return meta

    # ---- phase 5: sampled SA/ISA + .hwt (bwtonly=0 path) ---------------
    if not options.bwt_only:
        srate = max(1, options.sa_sampling_rate)
        irate = max(1, options.isa_sampling_rate)
        if sa is not None:
            formats.write_sampled_array(base + ".sa", srate, sa[::srate])
            formats.write_sampled_array(base + ".isa", irate, isa[::irate])
        else:
            # scaled engine keeps no full SA/ISA — derive the sampled
            # arrays with the bwtcomputessa walk from .bwt + .preisa
            # (exactly the reference's bwtonly=1 follow-up,
            # /root/reference/src/bwtcomputessa.cpp:51)
            write_meta()
            from .ssa import compute_ssa
            with log.span("sampled SA/ISA via LF walk (scaled path)"):
                compute_ssa(options.output_filename, srate, irate, log=log)
        files["sa"] = base + ".sa"
        files["isa"] = base + ".isa"
        from ..index.wavelet import HuffmanWaveletTree
        with log.span("write .hwt (Huffman wavelet tree)"):
            HuffmanWaveletTree.build(bwt).write(base + ".hwt")
        files["hwt"] = base + ".hwt"

    meta = write_meta()

    if bounded_spill:
        try:
            os.remove(bounded_spill)
        except OSError:
            pass
    log.v("%s runtime %.3fs" % (mem_usage_string(), rtc.elapsed()))
    return BwtResult(meta)


def main_bwtb3m(argv) -> int:
    """CLI driver matching /root/reference/src/bwtb3m.cpp:25-66."""
    from ..util.args import ArgInfo

    ai = ArgInfo(argv, progname="bwtb3m")
    if not ai.restargs:
        sys.stderr.write(
            "usage: bwtb3m inputtype=<bytestream|compactstream|pac|pacterm|"
            "lz4|utf-8> [outputfilename=..] [sasamplingrate=32] "
            "[isasamplingrate=262144] [mem=2G] [numthreads=8] [bwtonly=0] "
            "[tmpprefix=..] [verbose=1] <input>\n"
        )
        return 1
    options = BwtOptions.from_arginfo(ai)
    compute_bwt(options)
    return 0

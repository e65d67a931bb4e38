"""probeScanDna: k-mer abundance of query probes against a reference.

Reference (/root/reference/src/probeScanDna.cpp) supports three modes:
``words`` (3-bit packed k-mer sort + lookup scan, :141-423), ``hwt`` and
``rlhwt`` (backward search ``LF.step(sym, lo, hi)`` per symbol, :100-107),
reporting abundance histogram columns (``evaluateAcc``, :32-53).
"""

from __future__ import annotations

import sys
from typing import List

import numpy as np

from ..engine.result import BwtResult
from ..index.fm import FMIndex
from ..io.fasta import iter_fasta
from ..io import compact
from ..util.log import VerboseLog

_MAP = np.full(256, -1, dtype=np.int8)
for i, ch in enumerate(b"ACGT"):
    _MAP[ch] = i
    _MAP[ch + 32] = i


def _probe_kmers(seq: bytes, k: int) -> List[np.ndarray]:
    codes = _MAP[np.frombuffer(seq, dtype=np.uint8)].astype(np.int64)
    out = []
    for i in range(0, len(codes) - k + 1):
        km = codes[i : i + k]
        if (km >= 0).all():
            out.append(km)
    return out


def _evaluate_acc(counts: np.ndarray, log: VerboseLog) -> None:
    """Histogram columns: fraction of k-mers with abundance 0, 1, 2-10, >10
    (evaluateAcc role)."""
    total = max(1, len(counts))
    cols = [
        ("c0", np.count_nonzero(counts == 0)),
        ("c1", np.count_nonzero(counts == 1)),
        ("c2_10", np.count_nonzero((counts >= 2) & (counts <= 10))),
        ("c_gt10", np.count_nonzero(counts > 10)),
    ]
    log.m("  ".join("%s=%.4f" % (k, v / total) for k, v in cols))


def probe_scan(ref_path: str, probes_path: str, mode: str = "hwt",
               k: int = 31) -> int:
    log = VerboseLog(1)
    if mode == "occ":
        # batched mode: every k-mer of every probe is one lane of a
        # single backward-search sweep (k batched rank queries total) —
        # the device-scaled version of the hwt mode's per-symbol
        # LF.step loop (reference probeScanDna.cpp:100-107).
        import jax.numpy as jnp
        from ..ops.lf import backward_search_step

        result = BwtResult.load(ref_path)
        occt, symmap = result.load_occ(dense=True)
        shift = 1 if result.sigma == 5 else 0
        names, all_kmers, spans = [], [], []
        for name, seq in iter_fasta(probes_path):
            kms = _probe_kmers(seq, k)
            names.append(name)
            spans.append((len(all_kmers), len(all_kmers) + len(kms)))
            all_kmers.extend(kms)
        if all_kmers:
            km = jnp.asarray(np.stack(all_kmers).astype(np.int32) + shift)
            B = km.shape[0]
            lo = jnp.zeros(B, jnp.int32)
            hi = jnp.full(B, occt.n, jnp.int32)
            for j in range(k - 1, -1, -1):
                lo, hi = backward_search_step(occt, km[:, j], lo, hi)
            counts_all = np.maximum(np.asarray(hi) - np.asarray(lo), 0)
        else:
            counts_all = np.zeros(0, np.int64)
        for name, (a, b) in zip(names, spans):
            counts = counts_all[a:b]
            mean = float(counts.mean()) if len(counts) else 0.0
            matched = int(np.count_nonzero(counts)) if len(counts) else 0
            print("%s\t%d\t%d\t%.3f" % (name, len(counts), matched, mean))
        if len(counts_all):
            _evaluate_acc(counts_all.astype(np.int64), log)
        return 0
    if mode in ("hwt", "rlhwt"):
        result = BwtResult.load(ref_path)
        fm = FMIndex.from_bwt_result(
            result, structure="rlhwt" if mode == "rlhwt" else "hwt")
        # pacterm texts carry bases as {1..4}; pac/compact4 as {0..3}
        shift = 1 if result.sigma == 5 else 0

        def count(km: np.ndarray) -> int:
            return fm.count(km + shift)

    elif mode == "words":
        text, bits = compact.read_compact(ref_path)
        if k > 63:
            raise ValueError("words mode supports k <= 63")
        # k-mers are packed 2 bits per base: only 2-bit compact input
        # (fagzToCompact4 output, bases {0..3}) yields valid keys.  A 3-bit
        # compact stream (fagzToCompact, symbols {0..5}) would silently
        # corrupt every k-mer, so reject it.
        if bits != 2 or (len(text) and int(text.max()) > 3):
            raise ValueError(
                "words mode needs a 2-bit compact reference "
                "(fagzToCompact4 output with bases 0..3); got bits=%d" % bits)
        n = len(text)
        t = text.astype(np.uint64)
        nw = max(0, n - k + 1)
        if k <= 31:
            # single-word packed k-mers (reference uint64 width)
            packed = np.zeros(nw, dtype=np.uint64)
            for j in range(k):
                packed = (packed << np.uint64(2)) | t[j : nw + j]
            packed.sort(kind="stable")

            def count(km: np.ndarray) -> int:
                v = np.uint64(0)
                for c in km:
                    v = (v << np.uint64(2)) | np.uint64(c)
                lo = np.searchsorted(packed, v, side="left")
                hi = np.searchsorted(packed, v, side="right")
                return int(hi - lo)
        else:
            # two-word packed k-mers (reference uint128 width,
            # probeScanDna.cpp:482-486) via a structured (hi, lo) sort
            khi, klo = k - 31, 31
            hi_w = np.zeros(nw, dtype=np.uint64)
            for j in range(khi):
                hi_w = (hi_w << np.uint64(2)) | t[j : nw + j]
            lo_w = np.zeros(nw, dtype=np.uint64)
            for j in range(khi, k):
                lo_w = (lo_w << np.uint64(2)) | t[j : nw + j]
            packed = np.empty(nw, dtype=[("hi", "<u8"), ("lo", "<u8")])
            packed["hi"] = hi_w
            packed["lo"] = lo_w
            packed.sort(order=("hi", "lo"))

            def count(km: np.ndarray) -> int:
                vh = 0
                for c in km[:khi]:
                    vh = (vh << 2) | int(c)
                vl = 0
                for c in km[khi:]:
                    vl = (vl << 2) | int(c)
                key = np.array((vh, vl), dtype=packed.dtype)
                lo = np.searchsorted(packed, key, side="left")
                hi = np.searchsorted(packed, key, side="right")
                return int(hi - lo)

    else:
        sys.stderr.write("probeScanDna: unknown mode %r\n" % mode)
        return 1

    all_counts = []
    for name, seq in iter_fasta(probes_path):
        kmers = _probe_kmers(seq, k)
        counts = np.array([count(km) for km in kmers], dtype=np.int64)
        all_counts.append(counts)
        mean = float(counts.mean()) if len(counts) else 0.0
        matched = int(np.count_nonzero(counts)) if len(counts) else 0
        print("%s\t%d\t%d\t%.3f" % (name, len(counts), matched, mean))
    if all_counts:
        _evaluate_acc(np.concatenate(all_counts), log)
    return 0

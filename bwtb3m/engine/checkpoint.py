"""Durable merge-tree checkpointing — the reference's restartability.

The reference's whole design is file-granular restart: serializable
per-block sort jobs (``BwtMergeBlockSortRequest``,
/root/reference/src/checkbwt.cpp:24), durable tmp state under
``tmpprefix``/``sparsetmpprefix`` (/root/reference/src/bwtb3m.cpp:52-53),
and freshness-checked reuse (/root/reference/src/checkbwt.cpp:46-53).
Without it every region lives in RAM or device memory only, and a crash
late in a multi-hour build restarts it from zero.

This module persists each completed merge region (packed BWT + preisa
samples + r_start + hist ≈ 0.6-1.1 B/symbol) under ``tmpprefix`` as it
is produced, and on start resumes from the deepest complete tree nodes.
Writes are atomic (tmp file + rename) and run on a background thread so
the device keeps computing while the download + disk write drain;
files carry a build fingerprint (text crc + n + sigma + rate + block
size) so a stale tmp dir can never leak into a different build.  Once a
parent region is saved, its descendants' files are deleted — on-disk
state stays ~1 region set, like the reference's tmp discipline.
"""

from __future__ import annotations

import os
import zlib
from typing import Dict, List, Optional, Tuple

import numpy as np

MAGIC = "BWTREG1"


def build_key(text: np.ndarray, sigma: int, rate: int, block: int) -> str:
    """Cheap build fingerprint: crc of the text's head + tail + length
    and the plan parameters that shape the tree."""
    t = np.ascontiguousarray(text[: 1 << 20], np.uint8)
    h = zlib.crc32(t.tobytes())
    h = zlib.crc32(
        np.ascontiguousarray(text[-(1 << 16):], np.uint8).tobytes(), h)
    return "%08x-%d-%d-%d-%d" % (h & 0xFFFFFFFF, len(text), sigma, rate,
                                 block)


def region_path(prefix: str, key: str, s: int, e: int) -> str:
    return "%s_%s_reg_%d_%d.npz" % (prefix, MAGIC, hash_span(key, s, e),
                                    s)


def hash_span(key: str, s: int, e: int) -> int:
    return zlib.crc32(("%s:%d:%d" % (key, s, e)).encode()) & 0xFFFFFFFF


def _pack_host(bwt: np.ndarray, bits: int) -> np.ndarray:
    if bits == 8:
        return np.asarray(bwt, np.uint8)
    from .. import native
    b = np.asarray(bwt, np.uint8)
    if len(b) % 2:
        b = np.concatenate([b, np.zeros(1, np.uint8)])
    packed = native.pack_bits_u8(b, 4)
    if packed is None:
        from ..io.compact import pack_bits
        packed = np.asarray(pack_bits(b.astype(np.int64), 4), np.uint8)
    return packed


def _unpack_host(packed: np.ndarray, n: int, bits: int) -> np.ndarray:
    if bits == 8:
        return packed[:n]
    out = np.empty(len(packed) * 2, np.uint8)
    out[0::2] = packed & 0x0F
    out[1::2] = packed >> 4
    return out[:n]


def save_region_file(path: str, key: str, s: int, e: int, bits: int,
                     bwt: np.ndarray, samp_pos: np.ndarray,
                     samp_rank: np.ndarray, r_start: int,
                     hist: np.ndarray) -> None:
    tmp = path + ".part"
    with open(tmp, "wb") as f:
        np.savez(f, key=np.frombuffer(key.encode(), np.uint8),
                 s=np.int64(s), e=np.int64(e), bits=np.int64(bits),
                 packed=_pack_host(bwt, bits),
                 samp_pos=np.asarray(samp_pos, np.int64),
                 samp_rank=np.asarray(samp_rank, np.int64),
                 r_start=np.int64(r_start),
                 hist=np.asarray(hist, np.int64))
    os.replace(tmp, path)


def load_region_file(path: str, key: str
                     ) -> Optional[Tuple[int, int, np.ndarray, np.ndarray,
                                         np.ndarray, int, np.ndarray]]:
    """Returns (s, e, bwt, samp_pos, samp_rank, r_start, hist) or None if
    the file is unreadable or from a different build."""
    try:
        with np.load(path) as z:
            if bytes(z["key"]).decode() != key:
                return None
            s, e, bits = int(z["s"]), int(z["e"]), int(z["bits"])
            bwt = _unpack_host(z["packed"], e - s, bits)
            return (s, e, bwt, z["samp_pos"], z["samp_rank"],
                    int(z["r_start"]), z["hist"])
    except Exception:
        return None


class MergeCheckpointer:
    """Per-build checkpoint manager: async saves, resume scan, descendant
    cleanup.  ``min_symbols`` gates tiny regions (persisting a 4 KB test
    region is pointless; a 128 M one is ~70 MB and hours of work)."""

    def __init__(self, prefix: str, key: str, bits: int,
                 min_symbols: int = 1 << 26, sync: bool = False,
                 log=None):
        self.prefix = prefix
        self.key = key
        self.bits = bits
        self.min_symbols = min_symbols
        self.log = log
        self._sync = sync or bool(os.environ.get("BWTB3M_CKPT_SYNC"))
        self._pool = None
        self._pending: List = []
        self._saved: Dict[Tuple[int, int], str] = {}
        self._offered = set()

    # ------------------------------------------------------------ resume

    def scan(self) -> Dict[Tuple[int, int], str]:
        """Available saved regions of THIS build (key-verified lazily at
        load)."""
        import glob
        avail = {}
        for path in glob.glob("%s_%s_reg_*.npz" % (self.prefix, MAGIC)):
            try:
                with np.load(path) as z:
                    if bytes(z["key"]).decode() != self.key:
                        continue
                    avail[(int(z["s"]), int(z["e"]))] = path
            except Exception:
                continue
        return avail

    # ------------------------------------------------------------- saves

    def _do_save(self, s, e, bits, bwt_get, samp_pos, samp_rank, r_start,
                 hist):
        path = region_path(self.prefix, self.key, s, e)
        try:
            save_region_file(path, self.key, s, e, bits, bwt_get(),
                             samp_pos, samp_rank, r_start, hist)
        except Exception as exc:       # checkpointing must never kill a build
            if self.log:
                self.log.v("checkpoint save failed for [%d,%d): %r"
                           % (s, e, exc))
            return
        self._saved[(s, e)] = path
        if self.log:
            self.log.v("checkpointed region [%d,%d) -> %s" % (s, e, path))
        self._cleanup_descendants(s, e)

    def _cleanup_descendants(self, s: int, e: int) -> None:
        for (cs, ce), path in list(self._saved.items()):
            if (cs, ce) != (s, e) and cs >= s and ce <= e:
                try:
                    os.remove(path)
                except OSError:
                    pass
                del self._saved[(cs, ce)]

    def offer(self, region, bwt_get, force: bool = False) -> None:
        """Queue a completed region for persistence.  ``bwt_get`` is a
        zero-arg callable returning the host BWT bytes (for device-
        resident regions it performs the packed download INSIDE the
        worker thread, overlapping the fetch with device work).

        ``force`` bypasses the backlog cap — the engine uses it for the
        root merge's children so the resume point is never more than one
        level behind (a skipped offer is re-offerable: spans enter
        ``_offered`` only when actually submitted)."""
        s, e = region.s, region.e
        if (e - s < self.min_symbols or (s, e) in self._saved
                or (s, e) in self._offered):
            return
        # backlog cap: each queued save pins its region's device rows
        # (the packed download happens in the worker); letting levels
        # pile up would hold dead regions in HBM at flagship scale.
        # The cap is sized by PENDING BYTES (a fixed count of flagship
        # 128 M-symbol regions could pin gigabytes of host and device
        # memory), and every skip is a visible warning — at verbose-only
        # level a flagship build could silently degrade
        # resume-from-deepest-level to level 0.
        self._pending = [(f, b) for f, b in self._pending if not f.done()]
        region_bytes = (e - s) * self.bits // 8
        pending_bytes = sum(b for _f, b in self._pending)
        budget = int(os.environ.get("BWTB3M_CKPT_PENDING_BYTES",
                                    768 * 10 ** 6))
        if not force and self._pending and \
                pending_bytes + region_bytes > budget:
            if self.log:
                self.log.w("checkpoint backlog (%d B pending > %d B "
                           "budget): skipping save of [%d,%d)"
                           % (pending_bytes, budget, s, e))
            return
        self._offered.add((s, e))
        args = (s, e, self.bits, bwt_get, region.samp_pos.copy(),
                region.samp_rank.copy(), region.r_start,
                region.hist.copy())
        if self._sync:
            self._do_save(*args)
            return
        if self._pool is None:
            from concurrent.futures import ThreadPoolExecutor
            self._pool = ThreadPoolExecutor(max_workers=1)
        self._pending.append(
            (self._pool.submit(self._do_save, *args), region_bytes))

    def adopt(self, spans) -> None:
        """Record pre-existing files for spans loaded at resume so later
        parent saves clean them up too."""
        for span, path in spans.items():
            self._saved[span] = path

    def drain(self) -> None:
        for f, _b in self._pending:
            f.result()
        self._pending = []

    def finish(self, success: bool) -> None:
        """Join pending saves; on success remove every region file (the
        final outputs are durable — reference TempFileRemovalContainer
        role)."""
        self.drain()
        if self._pool is not None:
            self._pool.shutdown(wait=True)
        if success:
            for path in self._saved.values():
                try:
                    os.remove(path)
                except OSError:
                    pass
            self._saved.clear()

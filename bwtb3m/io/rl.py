"""Run-length encoded BWT files — the ``.bwt`` on-disk format.

Functional equivalent of the reference's ``huffman::RLEncoder/RLDecoder``
(the .bwt format written by bwtb3m and consumed by every downstream tool:
/root/reference/src/bwtb3mdecoderl.cpp:27-47 decode loop,
/root/reference/src/bwtdecodeblock.cpp:226-239 offset-seek decode,
``getBlockSymHistograms`` /root/reference/src/bwtdecodeblock.cpp:357). The
reference's exact bit layout lives in libmaus2 (not vendored); this framework
defines its own documented format "RLB1" (FORMATS.md) engineered for
vectorized numpy / native host codecs:

    header:
      magic        4B   b"RLB1"
      version      u8   1
      flags        u8   bit0: wide symbols (u32 instead of u8)
                        bit1: no per-block symbol-count table
      sigma        u32  alphabet size
      n            u64  decoded symbol count
      block_size   u32  symbols per block (runs never span blocks)
      footer_off   u64  absolute offset of the footer
    blocks (back to back), each:
      nruns        u32
      nbig         u32
      syms         u8[nruns]   (u32[nruns] if wide)
      len8         u8[nruns]   (run length, 255 == escape to big table)
      big_len      u64[nbig]   (lengths of the escaped runs, in run order)
    footer:
      block_off    u64[nb]            absolute offset of each block
      cum_counts   u64[(nb+1)*sigma]  symbol counts before each block
                                      (row nb = total histogram); omitted when
                                      flags bit1 is set

The per-block cumulative count table doubles as the reference's
``.sparserank`` sidecar (/root/reference/src/bwtdecodeblock.cpp:356-365):
rank queries at arbitrary positions need only one block decode.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from ..util import serial

MAGIC = b"RLB1"
DEFAULT_BLOCK = 1 << 16
_ESCAPE = 255

FLAG_WIDE = 1
FLAG_NO_COUNTS = 2


def _run_starts(symbols: np.ndarray) -> np.ndarray:
    n = len(symbols)
    if n == 0:
        return np.zeros(0, dtype=np.int64)
    diff = np.flatnonzero(symbols[1:] != symbols[:-1]) + 1
    return np.concatenate([[0], diff]).astype(np.int64)


def rl_encode(
    path: str,
    symbols: np.ndarray,
    sigma: Optional[int] = None,
    block_size: int = DEFAULT_BLOCK,
) -> None:
    """Write symbols to an RLB1 file."""
    symbols = np.asarray(symbols)
    n = int(len(symbols))
    if sigma is None:
        sigma = int(symbols.max()) + 1 if n else 1
    if sigma <= 256:
        from .. import native
        if native.rl_encode_u8(path, symbols, sigma, block_size):
            return
    wide = sigma > 256
    flags = (FLAG_WIDE if wide else 0)
    no_counts = sigma > 4096
    if no_counts:
        flags |= FLAG_NO_COUNTS
    nb = max(1, (n + block_size - 1) // block_size)

    with open(path, "wb") as f:
        f.write(MAGIC)
        serial.write_u8(f, 1)
        serial.write_u8(f, flags)
        serial.write_u32(f, sigma)
        serial.write_u64(f, n)
        serial.write_u32(f, block_size)
        footer_off_pos = f.tell()
        serial.write_u64(f, 0)  # footer offset, patched below

        block_off = np.zeros(nb, dtype=np.uint64)
        if not no_counts:
            cum = np.zeros((nb + 1, sigma), dtype=np.uint64)
        running = np.zeros(sigma, dtype=np.uint64)

        # split runs at block boundaries so each block decodes independently
        starts = _run_starts(symbols)
        bounds = np.arange(0, n, block_size, dtype=np.int64)
        all_starts = np.union1d(starts, bounds) if n else bounds
        all_ends = np.concatenate([all_starts[1:], [n]])
        lens = all_ends - all_starts
        syms = symbols[all_starts] if n else np.zeros(0, dtype=symbols.dtype)
        # which block each run belongs to
        run_block = all_starts // block_size if n else np.zeros(0, dtype=np.int64)
        run_block_bounds = np.searchsorted(run_block, np.arange(nb + 1))

        sym_dtype = "<u4" if wide else "u1"
        for b in range(nb):
            block_off[b] = f.tell()
            lo, hi = run_block_bounds[b], run_block_bounds[b + 1]
            bsyms = syms[lo:hi]
            blens = lens[lo:hi]
            big_mask = blens >= _ESCAPE
            len8 = np.where(big_mask, _ESCAPE, blens).astype(np.uint8)
            big_len = blens[big_mask].astype("<u8")
            serial.write_u32(f, int(hi - lo))
            serial.write_u32(f, int(big_mask.sum()))
            f.write(np.ascontiguousarray(bsyms, dtype=sym_dtype).tobytes())
            f.write(len8.tobytes())
            f.write(big_len.tobytes())
            if not no_counts:
                cum[b] = running
                if hi > lo:
                    np.add.at(running, bsyms.astype(np.int64), blens.astype(np.uint64))
        if not no_counts:
            cum[nb] = running

        footer_off = f.tell()
        serial.write_u64_array(f, block_off)
        if not no_counts:
            serial.write_u64_array(f, cum.reshape(-1))
        f.seek(footer_off_pos)
        serial.write_u64(f, footer_off)


class RLReader:
    """Random-access reader for RLB1 files (reference ``RLDecoder`` +
    ``IndexDecoderDataArray`` + sparserank roles combined)."""

    def __init__(self, path: str):
        self.path = path
        self._f = open(path, "rb")
        magic = self._f.read(4)
        if magic != MAGIC:
            raise ValueError("not an RLB1 file: %s (magic=%r)" % (path, magic))
        self.version = serial.read_u8(self._f)
        self.flags = serial.read_u8(self._f)
        self.sigma = serial.read_u32(self._f)
        self.n = serial.read_u64(self._f)
        self.block_size = serial.read_u32(self._f)
        self.footer_off = serial.read_u64(self._f)
        self.wide = bool(self.flags & FLAG_WIDE)
        self.has_counts = not (self.flags & FLAG_NO_COUNTS)
        self.nb = max(1, (self.n + self.block_size - 1) // self.block_size)
        self._f.seek(self.footer_off)
        self.block_off = serial.read_u64_array(self._f, self.nb)
        if self.has_counts:
            self.cum_counts = serial.read_u64_array(
                self._f, (self.nb + 1) * self.sigma
            ).reshape(self.nb + 1, self.sigma)
        else:
            self.cum_counts = None

    def close(self) -> None:
        if self._f is not None:
            self._f.close()
            self._f = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    @staticmethod
    def get_length(path: str) -> int:
        """Decoded length without reading payload (reference
        ``RLDecoder::getLength``, /root/reference/src/checkbwt.cpp:57)."""
        with open(path, "rb") as f:
            if f.read(4) != MAGIC:
                raise ValueError("not an RLB1 file: %s" % path)
            f.read(2)
            serial.read_u32(f)
            return serial.read_u64(f)

    def _read_block_runs(self, b: int) -> Tuple[np.ndarray, np.ndarray]:
        """Return (syms int32, lens int64) for block b."""
        self._f.seek(int(self.block_off[b]))
        nruns = serial.read_u32(self._f)
        nbig = serial.read_u32(self._f)
        sym_dtype, sym_bytes = ("<u4", 4) if self.wide else ("u1", 1)
        raw = self._f.read(nruns * sym_bytes + nruns + nbig * 8)
        syms = np.frombuffer(raw, dtype=sym_dtype, count=nruns).astype(np.int32)
        len8 = np.frombuffer(raw, dtype=np.uint8, count=nruns,
                             offset=nruns * sym_bytes).astype(np.int64)
        lens = len8.copy()
        if nbig:
            big = np.frombuffer(raw, dtype="<u8", count=nbig,
                                offset=nruns * sym_bytes + nruns).astype(np.int64)
            lens[len8 == _ESCAPE] = big
        return syms, lens

    def decode_block(self, b: int) -> np.ndarray:
        syms, lens = self._read_block_runs(b)
        return np.repeat(syms, lens)

    def decode_range(self, lo: int, hi: int) -> np.ndarray:
        """Decode symbols [lo, hi) (reference offset-seek ``RLDecoder``)."""
        if hi <= lo:
            return np.zeros(0, dtype=np.int32)
        b0 = lo // self.block_size
        b1 = (hi - 1) // self.block_size
        parts = [self.decode_block(b) for b in range(b0, b1 + 1)]
        cat = np.concatenate(parts)
        off = b0 * self.block_size
        return cat[lo - off : hi - off]

    def decode_all(self) -> np.ndarray:
        u8 = self.decode_all_u8()
        if u8 is not None:
            return u8.astype(np.int32)
        return self.decode_range(0, self.n)

    def decode_all_u8(self):
        """Whole-file decode as uint8 via the native stream decoder (the
        large-text path: no int32 blow-up); None for wide files or
        without the native lib."""
        if self.wide:
            return None
        from .. import native
        return native.rl_decode_u8(self.path, self.n)

    def iter_runs(self):
        """Yield (sym, runlength) pairs across the whole file, merging runs
        split at block boundaries (reference ``decodeRun`` loop semantics,
        /root/reference/src/bwtb3mdecoderl.cpp:27-47)."""
        pend_sym, pend_len = None, 0
        for b in range(self.nb):
            syms, lens = self._read_block_runs(b)
            for s, l in zip(syms.tolist(), lens.tolist()):
                if s == pend_sym:
                    pend_len += l
                else:
                    if pend_sym is not None:
                        yield pend_sym, pend_len
                    pend_sym, pend_len = s, l
        if pend_sym is not None and pend_len:
            yield pend_sym, pend_len

    def symbol_histogram(self) -> np.ndarray:
        """Total symbol counts (u64[sigma])."""
        if self.has_counts:
            return self.cum_counts[self.nb].copy()
        hist = np.zeros(self.sigma, dtype=np.uint64)
        for b in range(self.nb):
            syms, lens = self._read_block_runs(b)
            np.add.at(hist, syms.astype(np.int64), lens.astype(np.uint64))
        return hist

    def rank(self, c: int, i: int) -> int:
        """Number of occurrences of symbol c in positions [0, i).

        Block-table lookup + one partial block scan — the role of the
        reference's SparseRank (/root/reference/src/bwtdecodeblock.cpp:134-317).
        """
        if i <= 0:
            return 0
        i = min(i, self.n)
        b = i // self.block_size
        base = 0
        if self.has_counts:
            if b >= self.nb:
                return int(self.cum_counts[self.nb][c])
            base = int(self.cum_counts[b][c])
            rem = i - b * self.block_size
            if rem == 0:
                return base
            blk = self.decode_block(b)
            return base + int(np.count_nonzero(blk[:rem] == c))
        # slow path without the count table
        full = self.decode_range(0, i)
        return int(np.count_nonzero(full == c))


def open_bwt(path: str):
    """Open a .bwt file of either codec (RLB1 byte-aligned or RLH1
    Huffman+gamma) by magic dispatch."""
    with open(path, "rb") as f:
        magic = f.read(4)
    if magic == MAGIC:
        return RLReader(path)
    if magic == b"RLH1":
        from .rlh import RLHReader
        return RLHReader(path)
    raise ValueError("unknown .bwt magic %r in %s" % (magic, path))


def rl_decode(path: str) -> np.ndarray:
    with open_bwt(path) as r:
        return r.decode_all()

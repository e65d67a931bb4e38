"""Native C++ codec loader.

Compiles bwtb3m_native.cpp with g++ on first use (cached as a .so next to
this file), binds it via ctypes, and exposes numpy-typed wrappers. Every
entry point has a pure-Python fallback at its call site; importers should
use ``get_lib()`` and handle None.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import Optional

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "bwtb3m_native.cpp")
_SO = os.path.join(_DIR, "_bwtb3m_native.so")

_lock = threading.Lock()
_lib = None
_tried = False


def _build() -> bool:
    cmd = ["g++", "-O3", "-shared", "-fPIC", "-std=c++17",
           "-o", _SO + ".tmp", _SRC]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        os.replace(_SO + ".tmp", _SO)
        return True
    except (OSError, subprocess.SubprocessError):
        return False


def get_lib():
    """Returns the loaded ctypes library or None."""
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        if os.environ.get("BWTB3M_NO_NATIVE"):
            return None
        if not os.path.exists(_SO) or (
            os.path.getmtime(_SO) < os.path.getmtime(_SRC)
        ):
            if not _build():
                return None
        try:
            lib = ctypes.CDLL(_SO)
        except OSError:
            return None
        i64, i32, u8 = ctypes.c_int64, ctypes.c_int32, ctypes.c_uint8
        p64 = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
        p32 = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
        pu8 = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
        lib.c_pack_bits.argtypes = [p64, i64, ctypes.c_int, pu8, i64]
        lib.c_unpack_bits.argtypes = [pu8, i64, ctypes.c_int, p32]
        lib.c_lz4_compress.argtypes = [pu8, i64, pu8, i64]
        lib.c_lz4_compress.restype = i64
        lib.c_lz4_decompress.argtypes = [pu8, i64, pu8, i64]
        lib.c_lz4_decompress.restype = i64
        lib.c_gt0.argtypes = [p32, i64, pu8]
        lib.c_kasai_plcp.argtypes = [p32, p64, i64, p64]
        lib.c_run_scan.argtypes = [p32, i64, p32, p64]
        lib.c_run_scan.restype = i64
        pu64 = np.ctypeslib.ndpointer(np.uint64, flags="C_CONTIGUOUS")
        pu32 = np.ctypeslib.ndpointer(np.uint32, flags="C_CONTIGUOUS")
        lib.c_gamma_decode.argtypes = [pu8, i64, i64, pu64]
        lib.c_gamma_decode.restype = i64
        lib.c_rlh_decode.argtypes = [pu8, i64, i64, pu32, pu8, i64, p32, p64]
        lib.c_rlh_decode.restype = i64
        lib.c_sais.argtypes = [p32, i64, i64, p64]
        pi8 = np.ctypeslib.ndpointer(np.int8, flags="C_CONTIGUOUS")
        lib.c_cmp_rot.argtypes = [pu8, i64, i64, p64, i64, i64, pi8]
        lib.c_hist_u8.argtypes = [pu8, i64, i64, p64]
        lib.c_pack_bits_u8.argtypes = [pu8, i64, ctypes.c_int, pu8, i64]
        lib.c_unpack_pac.argtypes = [pu8, i64, ctypes.c_int, i64, pu8]
        lib.c_gap_interleave.argtypes = [pu8, i64, p64, p64, i64,
                                         pu8, i64, pu8, i64, pu8]
        u32 = ctypes.c_uint32
        lib.c_rl_encode_u8.argtypes = [ctypes.c_char_p, pu8, i64, u32, u32]
        lib.c_rl_encode_u8.restype = i64
        lib.c_rl_decode_u8.argtypes = [ctypes.c_char_p, pu8, i64]
        lib.c_rl_decode_u8.restype = i64
        _lib = lib
        return _lib


# ---------------------------------------------------------------- wrappers

def lz4_compress(data: bytes) -> Optional[bytes]:
    lib = get_lib()
    if lib is None:
        return None
    src = np.frombuffer(data, dtype=np.uint8)
    cap = len(data) + len(data) // 255 + 64
    dst = np.zeros(cap, dtype=np.uint8)
    size = lib.c_lz4_compress(np.ascontiguousarray(src), len(src), dst, cap)
    if size < 0:
        return None
    return dst[:size].tobytes()


def lz4_decompress(data: bytes, usize: int) -> Optional[bytes]:
    lib = get_lib()
    if lib is None:
        return None
    src = np.frombuffer(data, dtype=np.uint8)
    dst = np.zeros(max(1, usize), dtype=np.uint8)
    size = lib.c_lz4_decompress(np.ascontiguousarray(src), len(src), dst, usize)
    if size != usize:
        return None
    return dst[:usize].tobytes()


def sais(text: np.ndarray) -> Optional[np.ndarray]:
    """Suffix array of text + implicit smallest terminator via native
    SA-IS (the divsufsort-class CPU engine used as the honest baseline
    and host oracle). Returns int64 [n] or None without the native lib.
    For pacterm input (unique terminator 0 present) this equals the
    circular rotation order."""
    lib = get_lib()
    if lib is None:
        return None
    text = np.ascontiguousarray(text, dtype=np.int32)
    n = len(text)
    out = np.zeros(max(1, n), dtype=np.int64)
    if n:
        K = int(text.max()) + 1
        lib.c_sais(text, n, K, out)
    return out[:n]


def rl_encode_u8(path: str, symbols: np.ndarray, sigma: int,
                 block_size: int) -> bool:
    """Stream-speed RLB1 writer (sigma <= 256). Returns False without the
    native lib (caller falls back to the numpy encoder)."""
    lib = get_lib()
    if lib is None or sigma > 256:
        return False
    syms = np.ascontiguousarray(symbols, dtype=np.uint8)
    rc = lib.c_rl_encode_u8(path.encode(), syms, len(syms), sigma,
                            block_size)
    return rc == 0


def rl_decode_u8(path: str, n: int):
    """Whole-file RLB1 decode to uint8; None without the native lib or on
    wide-symbol files."""
    lib = get_lib()
    if lib is None:
        return None
    out = np.zeros(max(1, n), dtype=np.uint8)
    rc = lib.c_rl_decode_u8(path.encode(), out, len(out))
    if rc != n:
        return None
    return out[:n]


def cmp_rot(text: np.ndarray, n: int, e: int, xs: np.ndarray,
            nthreads: int = 4) -> Optional[np.ndarray]:
    """Three-way circular compare sign(rot(x) - rot(e)) for each x in xs.
    text: the plain uint8 text (n bytes; spans wrap modularly in C).
    Returns int8 [len(xs)] or None without the native lib."""
    lib = get_lib()
    if lib is None:
        return None
    xs = np.ascontiguousarray(xs, dtype=np.int64)
    out = np.zeros(max(1, len(xs)), dtype=np.int8)
    if len(xs):
        lib.c_cmp_rot(np.ascontiguousarray(text, np.uint8), n, e,
                      xs, len(xs), nthreads, out)
    return out[: len(xs)]


def hist_u8(text: np.ndarray, nthreads: int = 8,
            minlength: int = 256) -> Optional[np.ndarray]:
    """int64 symbol histogram of a uint8 array (multithreaded C).
    numpy bincount is far below memory bandwidth; this runs at memory
    bandwidth.  Returns int64 [max(256, minlength)] or None."""
    lib = get_lib()
    if lib is None:
        return None
    t = np.ascontiguousarray(text, np.uint8)
    out = np.zeros(256, np.int64)
    if len(t):
        lib.c_hist_u8(t, len(t), nthreads, out)
    if minlength > 256:
        out = np.concatenate([out, np.zeros(minlength - 256, np.int64)])
    return out


def byte_hist(text: np.ndarray, minlength: int = 256,
              nthreads: int = 8) -> np.ndarray:
    """hist_u8 with a numpy fallback (always returns an array)."""
    out = hist_u8(text, nthreads=nthreads, minlength=minlength)
    if out is not None:
        return out
    return np.bincount(np.asarray(text, np.uint8),
                       minlength=max(256, minlength)).astype(np.int64)


def pack_bits_u8(syms: np.ndarray, bits: int) -> Optional[np.ndarray]:
    """Pack uint8 symbols LSB-first at `bits` bits each (large-array path
    without the int64 staging copy). Returns packed uint8 or None."""
    lib = get_lib()
    if lib is None:
        return None
    syms = np.ascontiguousarray(syms, dtype=np.uint8)
    nbytes = (len(syms) * bits + 7) // 8
    out = np.zeros(max(1, nbytes), dtype=np.uint8)
    lib.c_pack_bits_u8(syms, len(syms), bits, out, nbytes)
    return out[:nbytes]


def unpack_pac(payload: np.ndarray, n: int, shift: int = 0,
               nthreads: int = 4) -> Optional[np.ndarray]:
    """BWA .pac payload bytes -> n uint8 base codes (+shift). Returns
    None when the native library is unavailable (callers fall back to
    the numpy broadcast in io/pac.py)."""
    lib = get_lib()
    if lib is None:
        return None
    payload = np.ascontiguousarray(payload, dtype=np.uint8)
    nbytes = (n + 3) // 4
    if nbytes > len(payload):
        raise ValueError("pac payload shorter than base count")
    out = np.empty(max(1, nbytes * 4), dtype=np.uint8)
    lib.c_unpack_pac(payload, nbytes, shift, nthreads, out)
    return out[:n]


def gap_interleave(gap8: np.ndarray, ov_idx: np.ndarray, ov_val: np.ndarray,
                   left: np.ndarray, right: np.ndarray) -> Optional[np.ndarray]:
    """Zip two BWT halves guided by a byte-compressed gap histogram
    (gap8[r]==255 -> overflow list). Returns merged uint8 or None."""
    lib = get_lib()
    if lib is None:
        return None
    left = np.ascontiguousarray(left, dtype=np.uint8)
    right = np.ascontiguousarray(right, dtype=np.uint8)
    out = np.zeros(len(left) + len(right), dtype=np.uint8)
    lib.c_gap_interleave(
        np.ascontiguousarray(gap8, np.uint8), len(gap8),
        np.ascontiguousarray(ov_idx, np.int64),
        np.ascontiguousarray(ov_val, np.int64), len(ov_idx),
        left, len(left), right, len(right), out)
    return out


def gt0(text: np.ndarray) -> Optional[np.ndarray]:
    lib = get_lib()
    if lib is None:
        return None
    text = np.ascontiguousarray(text, dtype=np.int32)
    out = np.zeros(len(text), dtype=np.uint8)
    lib.c_gt0(text, len(text), out)
    return out


def kasai_plcp(text: np.ndarray, sa: np.ndarray) -> Optional[np.ndarray]:
    lib = get_lib()
    if lib is None:
        return None
    text = np.ascontiguousarray(text, dtype=np.int32)
    sa = np.ascontiguousarray(sa, dtype=np.int64)
    out = np.zeros(len(text), dtype=np.int64)
    lib.c_kasai_plcp(text, sa, len(text), out)
    return out


def gamma_decode(bits: np.ndarray, count: int):
    """Decode gamma codes from a 0/1 bit array; None if no native lib."""
    lib = get_lib()
    if lib is None:
        return None
    packed = np.packbits(np.ascontiguousarray(bits, np.uint8),
                         bitorder="little")
    out = np.zeros(max(1, count), dtype=np.uint64)
    used = lib.c_gamma_decode(packed, len(bits), count, out)
    if used < 0:
        return None
    return out[:count]


def rlh_decode_runs(payload: bytes, nbits: int, nruns: int,
                    canon_syms: np.ndarray, canon_lens: np.ndarray):
    """Decode huffman+gamma run pairs; None if no native lib or error."""
    lib = get_lib()
    if lib is None:
        return None
    data = np.frombuffer(payload, dtype=np.uint8)
    run_syms = np.zeros(max(1, nruns), dtype=np.int32)
    run_lens = np.zeros(max(1, nruns), dtype=np.int64)
    used = lib.c_rlh_decode(
        np.ascontiguousarray(data), nbits, nruns,
        np.ascontiguousarray(canon_syms, np.uint32),
        np.ascontiguousarray(canon_lens, np.uint8),
        len(canon_syms), run_syms, run_lens)
    if used < 0:
        return None
    return run_syms[:nruns], run_lens[:nruns]

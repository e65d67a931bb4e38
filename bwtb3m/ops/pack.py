"""Device-side k-bit pack/unpack kernels.

Compact texts travel to the device as their packed bytes (4-32x less
host->device transfer than int32 symbols) and are unpacked on device.
Counterpart of the host codecs in io/compact.py (identical LSB-first
layout).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax


@partial(jax.jit, static_argnums=(1, 2))
def unpack_bits_device(data: jnp.ndarray, bits: int, n: int) -> jnp.ndarray:
    """uint8 packed bytes -> int32 symbols [n] (LSB-first layout).

    All intermediates are 1-D: no [nbytes, 8/bits]-shaped staging array
    whose narrow minor dimension a tiled layout would pad."""
    if n == 0:
        return jnp.zeros(0, jnp.int32)
    if 8 % bits == 0:
        # aligned fast path: each byte holds 8//bits whole symbols
        per = 8 // bits
        total = data.shape[0] * per
        arr = jnp.repeat(data, per, total_repeat_length=total)
        pos = lax.broadcasted_iota(jnp.uint8, (total,), 0)
        sh = (pos % jnp.uint8(per)) * jnp.uint8(bits)
        syms = (arr >> sh) & jnp.uint8((1 << bits) - 1)
        return syms[:n].astype(jnp.int32)
    # general path: explode to bits (1-D), regroup by strided slices
    nbits = data.shape[0] * 8
    arr = jnp.repeat(data, 8, total_repeat_length=nbits)
    pos = lax.broadcasted_iota(jnp.uint8, (nbits,), 0)
    bitarr = ((arr >> (pos % jnp.uint8(8))) & jnp.uint8(1)).astype(jnp.int32)
    out = jnp.zeros(n, jnp.int32)
    for b in range(bits):
        out = out | (bitarr[b::bits][:n] << b)
    return out


@partial(jax.jit, static_argnums=(1,))
def pack_bits_device(symbols: jnp.ndarray, bits: int) -> jnp.ndarray:
    """int32 symbols -> uint8 packed bytes (LSB-first layout). The symbol
    count must make the bit stream byte-aligned (n*bits % 8 == 0); callers
    pad first."""
    n = symbols.shape[0]
    assert (n * bits) % 8 == 0, "pad to byte alignment before packing"
    assert bits <= 8, "pack_bits_device extracts bits from a uint8 copy; " \
        "symbols wider than 8 bits would truncate silently"
    mask = jnp.uint8((1 << bits) - 1)
    if 8 % bits == 0:
        # 1-D strided combine (2-D staging would tile-pad the minor dim)
        per = 8 // bits
        s = symbols.astype(jnp.uint8) & mask
        out = jnp.zeros(n // per, jnp.uint8)
        for k in range(per):
            out = out | (s[k::per] << jnp.uint8(k * bits))
        return out
    s = symbols.astype(jnp.uint8) & mask
    nbits = n * bits
    bitarr = jnp.zeros(nbits, jnp.uint8)
    for b in range(bits):
        bitarr = bitarr.at[b::bits].set((s >> b) & jnp.uint8(1))
    out = jnp.zeros(nbits // 8, jnp.uint8)
    for k in range(8):
        out = out | (bitarr[k::8] << jnp.uint8(k))
    return out


def load_compact_to_device(path: str):
    """Read a CAR1 file and unpack it on device. Returns (symbols, bits)."""
    from ..io import compact as cio

    with open(path, "rb") as f:
        bits, n = cio.read_compact_header(f)
        nbytes = (n * bits + 7) // 8
        data = np.frombuffer(f.read(nbytes), dtype=np.uint8)
    return unpack_bits_device(jnp.asarray(data), bits, n), bits

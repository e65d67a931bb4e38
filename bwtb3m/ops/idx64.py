"""uint32-indexed gather/scatter that stay correct past 2^31.

``jnp.take`` / ``x[idx]`` convert indices to int32 when x64 is disabled,
so any element index >= 2^31 silently wraps negative and clamps/drops —
so a block past position 2^31 would get a silently wrong BWT.  Raw
``lax.gather``/``lax.scatter`` accept uint32 index operands natively and
treat them as unsigned (tests/test_idx64.py pins this against a
>2^31-element array), so texts up to 2^32-1 symbols need no 64-bit
emulation.

Reference role: the 64-bit ubiquitous positions of the reference drivers
(e.g. /root/reference/src/lcpbit.cpp:552-557 bounds text length only by
rlimit/disk).
"""

from __future__ import annotations

import jax.numpy as jnp
from jax import lax


def take_u32(arr: jnp.ndarray, idx: jnp.ndarray) -> jnp.ndarray:
    """arr[idx] along axis 0 with uint32 indices (CLIP out-of-range).

    ``arr`` may have trailing dimensions (row gather); ``idx`` is any
    shape of uint32 element/row indices.
    """
    idx = idx.astype(jnp.uint32)
    flat = idx.reshape(-1)
    trailing = arr.shape[1:]
    dnums = lax.GatherDimensionNumbers(
        offset_dims=tuple(range(1, 1 + len(trailing))),
        collapsed_slice_dims=(0,),
        start_index_map=(0,),
    )
    out = lax.gather(
        arr, flat[:, None], dnums, slice_sizes=(1,) + trailing,
        mode=lax.GatherScatterMode.CLIP)
    return out.reshape(idx.shape + trailing)


def take2d_u32(arr2d: jnp.ndarray, row: jnp.ndarray,
               col: jnp.ndarray) -> jnp.ndarray:
    """Element gather arr2d[row[j], col[j]] with uint32 indices (CLIP).

    The 2-index form keeps big buffers addressable with 32-bit indices:
    each DIMENSION indexes to 2^31-1 only, so a [nrows, 256] text
    addresses 2^32+ symbols while a flat 1-D view breaks past 2^31
    (see ops/gapdev.build_text_rows)."""
    row = row.astype(jnp.uint32).reshape(-1)
    col = col.astype(jnp.uint32).reshape(-1)
    dnums = lax.GatherDimensionNumbers(
        offset_dims=(),
        collapsed_slice_dims=(0, 1),
        start_index_map=(0, 1),
    )
    idx = jnp.stack([row, col], axis=1)
    return lax.gather(arr2d, idx, dnums, slice_sizes=(1, 1),
                      mode=lax.GatherScatterMode.CLIP)


def scatter_set_u32(out: jnp.ndarray, idx: jnp.ndarray,
                    vals: jnp.ndarray) -> jnp.ndarray:
    """out.at[idx].set(vals) with uint32 indices; out-of-range drops
    (mode='drop' semantics — sentinel rows use idx >= len(out))."""
    idx = idx.astype(jnp.uint32).reshape(-1)
    vals = vals.reshape(-1).astype(out.dtype)
    dnums = lax.ScatterDimensionNumbers(
        update_window_dims=(),
        inserted_window_dims=(0,),
        scatter_dims_to_operand_dims=(0,),
    )
    return lax.scatter(
        out, idx[:, None], vals, dnums,
        mode=lax.GatherScatterMode.FILL_OR_DROP,
        unique_indices=False, indices_are_sorted=False)

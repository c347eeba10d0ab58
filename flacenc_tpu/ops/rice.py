"""Batched partitioned-Rice parameter search on device.

Batched reformulation of ``/root/reference/src/rice.rs``: instead of two
u32x16 SIMD registers per partition, the cost table is a dense
``(..., nparts, 32)`` tensor built by shifted sums over the finest
partitioning; coarser orders are produced by a log-depth pairwise merge, and
the (parameter, order) argmins are packed-integer reductions that reproduce
the reference's tie-breaking exactly ((bits << 5) | p with u32 wrap,
rice.rs:115-141). Works on any leading batch shape.

Deviation (DESIGN.md): partition sums accumulate in i64 and clamp once to
(1<<27)-1 instead of the reference's per-16-sample saturating u32 chain.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

from . import jax_env  # noqa: F401  (enables x64)

import jax
import jax.numpy as jnp
import numpy as np

from .. import constants

MAX_P_TO_BITS = (1 << 27) - 1  # rice.rs:51
_N_P = 32  # table covers rice parameters 0..=31


def finest_partition_order(size: int, min_part_size: int) -> int:
    """Static finest partition order (rice.rs:157-165)."""
    assert min_part_size >= 1
    max_splits = size // min_part_size
    if max_splits == 0:
        return 0
    max_order = max_splits.bit_length() - 1
    trailing = (size & -size).bit_length() - 1 if size else 0
    return min(constants.rice.MAX_PARTITION_ORDER, max_order, trailing)


def encode_signbit(v: jnp.ndarray) -> jnp.ndarray:
    """Zigzag to u32: (|v| << 1) - (v < 0) (rice.rs:169-176)."""
    v64 = jnp.abs(v.astype(jnp.int64))
    z = (v64 << 1) - (v < 0).astype(jnp.int64)
    return z.astype(jnp.uint32)


class RiceSearchResult(NamedTuple):
    """Best partitioned-Rice parameters per batch element.

    Shapes use leading batch dims ``...``; `max_parts` = 2**finest_order.
    """

    partition_order: jnp.ndarray  # (...,) int32
    params: jnp.ndarray  # (..., max_parts) int32; valid for first 2**order
    code_bits: jnp.ndarray  # (...,) int64 — table cost (incl. 4-bit offsets)
    use_rice2: jnp.ndarray  # (...,) bool — any selected param > 14


def _finest_tables(
    z: jnp.ndarray, warmup: jnp.ndarray, finest_order: int, block_size: int
) -> jnp.ndarray:
    """(..., nparts, 32) i64 cost tables at the finest partition order.

    bits[part, p] = clamp(sum_{t in part, t >= warmup}(z[t] >> p)
                          + 4 + len_part * (p + 1))
    where len of partition 0 excludes the warmup samples (rice.rs:270-276).
    """
    nparts = 1 << finest_order
    part_len = block_size // nparts
    t_idx = jnp.arange(block_size, dtype=jnp.int32)
    warm = warmup[..., None].astype(jnp.int32)
    z_masked = jnp.where(t_idx < warm, jnp.uint32(0), z)
    zp = z_masked.reshape(z.shape[:-1] + (nparts, part_len))
    ps = jnp.arange(_N_P, dtype=jnp.uint32)
    # shifted sums: loop over p is unrolled at trace time (32 passes)
    sums = jnp.stack(
        [
            (zp >> p).astype(jnp.int64).sum(axis=-1)
            for p in range(_N_P)
        ],
        axis=-1,
    )  # (..., nparts, 32)
    sums = jnp.minimum(sums, MAX_P_TO_BITS)
    # length terms: partition 0 loses `warmup` samples
    lens = jnp.full((nparts,), part_len, dtype=jnp.int64)
    lens = jnp.broadcast_to(lens, warm.shape[:-1] + (nparts,)).at[..., 0].add(
        -warmup.astype(jnp.int64)
    )
    bits = sums + 4 + lens[..., None] * (ps.astype(jnp.int64) + 1)[None, :]
    return jnp.minimum(bits, MAX_P_TO_BITS)


def _minimize_tables(tables: jnp.ndarray, max_p: int) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Per-partition (param, bits) minimizer with reference tie-breaking.

    packed = ((bits << 5) & u32) | p, masked entries use bits = u32::MAX
    (rice.rs:115-141); min over p prefers smaller p on ties.
    """
    ps = jnp.arange(_N_P, dtype=jnp.uint32)
    bits_u32 = tables.astype(jnp.uint32)
    bits_u32 = jnp.where(ps <= max_p, bits_u32, jnp.uint32(0xFFFFFFFF))
    packed = (bits_u32 << jnp.uint32(5)) | ps
    m = packed.min(axis=-1)
    return (m & jnp.uint32(0x1F)).astype(jnp.int32), (m >> jnp.uint32(5)).astype(jnp.int64)


def find_partitioned_rice_parameters(
    errors: jnp.ndarray,
    warmup: jnp.ndarray,
    block_size: int,
    max_p: int,
    min_partition_warmup_bound: int = constants.qlpc.MAX_ORDER,
) -> RiceSearchResult:
    """Full bottom-up search over partition orders (rice.rs:246-299).

    `errors`: (..., T) int32 residuals; `warmup`: (...,) per-element warmup
    length (< MIN_PARTITION_SIZE, so the finest order is static).
    """
    assert min_partition_warmup_bound <= constants.rice.MIN_PARTITION_SIZE
    finest = finest_partition_order(block_size, constants.rice.MIN_PARTITION_SIZE)
    max_parts = 1 << finest
    z = encode_signbit(errors)
    tables = _finest_tables(z, warmup, finest, block_size)

    n_orders = finest + 1
    batch_shape = errors.shape[:-1]
    # per-order results, ordered finest..0 so argmin tie-breaks toward the
    # finest order like the reference's strictly-decreasing update loop
    # (rice.rs:277-291)
    all_params = []
    all_bits = []
    order_tables = tables
    for order in range(finest, -1, -1):
        params_o, bits_o = _minimize_tables(order_tables, max_p)
        total_o = bits_o.sum(axis=-1)
        pad = jnp.zeros(batch_shape + (max_parts - (1 << order),), jnp.int32)
        all_params.append(jnp.concatenate([params_o, pad], axis=-1))
        all_bits.append(total_o)
        if order > 0:
            merged = order_tables[..., 0::2, :] + order_tables[..., 1::2, :] - 4
            order_tables = jnp.minimum(merged, MAX_P_TO_BITS)

    bits_by_order = jnp.stack(all_bits, axis=-1)  # (..., n_orders) finest-first
    params_by_order = jnp.stack(all_params, axis=-2)  # (..., n_orders, max_parts)
    best_idx = jnp.argmin(bits_by_order, axis=-1)  # first min → finest wins ties
    best_order = (finest - best_idx).astype(jnp.int32)
    best_bits = jnp.take_along_axis(bits_by_order, best_idx[..., None], -1)[..., 0]
    best_params = jnp.take_along_axis(
        params_by_order, best_idx[..., None, None], -2
    )[..., 0, :]
    # params beyond 2**best_order are padding; mask for the rice2 check
    part_idx = jnp.arange(max_parts, dtype=jnp.int32)
    valid = part_idx < (1 << best_order)[..., None]
    use_rice2 = jnp.any(valid & (best_params > 14), axis=-1)
    return RiceSearchResult(best_order, jnp.where(valid, best_params, 0), best_bits, use_rice2)


def residual_count_bits(res: RiceSearchResult) -> jnp.ndarray:
    """Exact `Residual::count_bits` from search outputs (bitrepr.rs:533-543).

    table cost = 4*nparts + quotient_bits + remainder_bits, so
    count = code_bits + 6 + nparts * (param_bits - 4).
    """
    nparts = (jnp.int64(1) << res.partition_order.astype(jnp.int64))
    return res.code_bits + 6 + jnp.where(res.use_rice2, nparts, 0)

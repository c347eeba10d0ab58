"""Batched fixed-predictor kernels.

Batched reformulation of the reference's diff cascade
(``/root/reference/src/coding.rs:178-197``) and partitioned entropy
estimator (coding.rs:200-227): all five orders are computed for every
block/channel at once as `(..., 5, T)` tensors; the estimator's partition
loop is unrolled at trace time (partition boundaries are static).
"""

from __future__ import annotations

from typing import Tuple

from . import jax_env  # noqa: F401

import jax
import jax.numpy as jnp
import numpy as np

from .. import constants

MAX_FIXED_ORDER = constants.fixed.MAX_LPC_ORDER  # 4


def fixed_lpc_errors(signal: jnp.ndarray) -> jnp.ndarray:
    """Difference cascades: (..., T) i32 -> (..., 5, T) i32 (wrapping).

    e_{k+1}[t] = e_k[t] - e_k[t-1] with e_k[-1] = 0; the first k entries of
    e_k are partial diffs, exactly like the reference's carry semantics.
    """
    errs = [signal.astype(jnp.int32)]
    for _ in range(MAX_FIXED_ORDER):
        prev = errs[-1]
        shifted = jnp.pad(prev[..., :-1], [(0, 0)] * (prev.ndim - 1) + [(1, 0)])
        errs.append(prev - shifted)
    return jnp.stack(errs, axis=-2)


def _log2_f32(x: jnp.ndarray) -> jnp.ndarray:
    """f32 log2 as the reference's libm log2f gives it: computed in f64 and
    rounded once. XLA's f32 log2 is log(x)/log(2) with the backend's own
    f32 log, which differs by an ulp often enough to flip the truncated
    estimate (measured on an H100: 8 of 5,120 block x channel x order
    estimates, 0 with this form)."""
    return jnp.log2(x.astype(jnp.float64)).astype(jnp.float32)


def estimate_entropy(
    errors: jnp.ndarray, warmup_len: jnp.ndarray, partitions: int, block_size: int
) -> jnp.ndarray:
    """Approximate bit-cost estimate (coding.rs:200-227), f32 semantics.

    `errors`: (..., T) i32; `warmup_len`: (...,) i32 (static-shaped, traced
    values). Returns (...,) i64 accumulated truncated partition costs.
    Float32 elsewhere: XLA:GPU may reorder the partition sums (exact while
    a sum stays below 2**24) and contract the multiply-adds into FMAs.
    """
    partition_size = -(-block_size // partitions)
    # |err| in i32 is exact here: fixed-LPC residuals of valid inputs are
    # bounded by 2^30 (<= 26-bit samples x sum|binomial(4,k)| = 16), so
    # INT32_MIN is unreachable and the i64 detour is unnecessary work
    abs_f32 = jnp.abs(errors).astype(jnp.float32)
    acc = jnp.zeros(errors.shape[:-1], dtype=jnp.int64)
    offset = 0
    warm = warmup_len.astype(jnp.int64)
    for _p in range(partitions):
        end = min(block_size, offset + partition_size)
        partition_len = end - offset
        if partition_len <= 0:
            break
        # reference guard: `if end >= warmup_len` (warmup <= 64 <= end in
        # practice except tiny first partitions)
        active = end >= warm
        sample_count = jnp.minimum(end - warm, partition_len).astype(jnp.float32)
        sum_errors = abs_f32[..., offset:end].sum(axis=-1, dtype=jnp.float32)
        avg_errors = sum_errors * jnp.float32(2.0) / (
            sample_count + jnp.float32(0.00001)
        )
        geom_p = jnp.float32(1.0) / (avg_errors + jnp.float32(1.0))
        # avg == 0 gives 0 * -inf = NaN; Rust's `as usize` maps NaN/neg to 0
        xent = avg_errors * (-_log2_f32(jnp.float32(1.0) - geom_p)) + (
            -_log2_f32(geom_p)
        )
        contrib = xent * sample_count
        contrib = jnp.where(
            jnp.isnan(contrib) | (contrib < 0) | ~active, 0.0, contrib
        )
        acc = acc + contrib.astype(jnp.int64)  # f32 -> int truncates
        offset = end
    return acc

"""Device-mesh sharding for batched block encoding.

Frame-level data parallelism (reference: worker threads over crossbeam
channels, ``src/par.rs:109-193``) maps to sharding the block-batch axis of
every `(B, C, T)` tensor across a 1-D `jax.sharding.Mesh`. Blocks are
independent, so the hot path needs no collectives; cross-device stats
(total bits, for progress reporting) use a single `psum` inside
`shard_map`.
"""

from __future__ import annotations

from typing import Optional, Sequence

from ..ops import jax_env  # noqa: F401

import jax
import jax.numpy as jnp
import numpy as np
from jax import shard_map
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


BLOCK_AXIS = "blocks"


def block_mesh(devices: Optional[Sequence] = None) -> Mesh:
    """1-D mesh over all (or given) devices; axis name "blocks"."""
    if devices is None:
        devices = jax.devices()
    return Mesh(np.asarray(devices), (BLOCK_AXIS,))


def shard_encoder_fn(encode_batch, mesh: Mesh):
    """Wraps a single-device `encode_batch(blocks)` into a mesh-sharded jit.

    Inputs/outputs are sharded on the leading (block-batch) axis; the
    per-device program is identical to the single-chip one, so XLA emits no
    collectives in the hot path.
    """
    data_sharding = NamedSharding(mesh, P(BLOCK_AXIS))

    def sharded(blocks):
        return encode_batch(blocks)

    return jax.jit(
        sharded,
        in_shardings=NamedSharding(mesh, P(BLOCK_AXIS, None, None)),
        out_shardings=data_sharding,
    )


def total_bits_psum(sf_bits: jnp.ndarray, mesh: Mesh) -> jnp.ndarray:
    """Aggregate subframe bits across the mesh (one psum collective)."""
    def local_sum(x):
        return jax.lax.psum(x.sum(), BLOCK_AXIS)

    return shard_map(
        local_sum,
        mesh=mesh,
        in_specs=P(BLOCK_AXIS, None),
        out_specs=P(),
    )(sf_bits)


def shard_corpus(paths: Sequence[str], n_hosts: int, host_id: int) -> list:
    """Deterministic multi-host corpus sharding (DCN level).

    The reference's par-mode is intra-process; the scale-out for corpus
    encoding across hosts is process-level: each host takes a strided shard of
    the file list (size-agnostic, deterministic, no coordination needed —
    files are independent) and runs `parallel.encode_corpus` on its local
    devices. Combine with `jax.distributed.initialize()` on several hosts.
    """
    assert 0 <= host_id < n_hosts
    return list(paths[host_id::n_hosts])

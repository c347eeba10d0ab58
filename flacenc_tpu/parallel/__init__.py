"""Throughput and multi-device layer (the reference's ``src/par.rs`` analogue).

The reference parallelizes with worker threads + crossbeam channels; here
the batch axis IS the parallelism: blocks are independent, so the batch is
sharded over a device mesh (`mesh.py`) and the host<->device pipeline is
double-buffered (`pipeline.py`), with ordered frame reassembly on the host
(the `ParSink` BTreeMap analogue is just list order).
"""

from .mesh import block_mesh, shard_corpus, shard_encoder_fn
from .pipeline import PipelineStats, encode_corpus


def determine_worker_count(cfg=None) -> int:
    """Host pack-thread count with the reference's precedence
    (par.rs:328-339): ``config.workers`` -> env ``FLACENC_WORKERS`` ->
    available parallelism. ``multithread=False`` forces 1 (the serial
    path, coding.rs:650-654). FLACENC_PACK_THREADS remains an override
    BELOW config (it predates the config knobs; kept for compatibility).

    In this framework host threads only run the C++ frame packer — the
    device pipeline's I/O thread is the link driver, not a worker pool —
    so this is the knob the reference's worker count maps to.
    """
    import os

    from .. import constants

    if cfg is not None:
        if not getattr(cfg, "multithread", True):
            return 1
        workers = getattr(cfg, "workers", None)
        if workers:
            return max(1, int(workers))
    for key in (constants.ENV_DEFAULT_PARALLELISM, "FLACENC_PACK_THREADS"):
        try:
            n = int(os.environ.get(key, ""))
        except ValueError:
            continue
        if n >= 1:
            return n
    return os.cpu_count() or 1


__all__ = [
    "block_mesh",
    "shard_corpus",
    "shard_encoder_fn",
    "encode_corpus",
    "PipelineStats",
    "determine_worker_count",
]

"""Corpus-level throughput pipeline (the ``src/par.rs`` analogue).

The reference parallelizes one stream across worker threads fed by bounded
refill queues with a dedicated MD5 thread (par.rs:109-193, 196-277,
288-325). The batched equivalent batches blocks from MANY files into
shared `(B, C, T)` device batches so a corpus encode keeps the chip full
regardless of file lengths, with the same boundedness properties:

- blocks are STREAMED from open sources into shared batches; at most
  `depth` batches (plus one partial batch per sample rate) of raw PCM are
  resident at any time — a corpus larger than RAM encodes fine;
- upload + device dispatch + decisions download run on a background
  thread (the refill-queue overlap of par.rs:288-325);
- MD5 runs on a dedicated thread consuming blocks through a bounded(16)
  queue with an overdue counter (par.rs:196-277, 411-421);
- ordered reassembly happens per file keyed by frame index (the `ParSink`
  BTreeMap analogue, par.rs:67-95).

Pipeline statistics measure what they claim: `read_s` is time inside
`Source.read_samples`, `device_wait_s` is time blocked on device results,
`pack_s` is host frame assembly, `md5_wait_s`/`md5_overdue` mirror
par-mode's md5_overdue JSONL counter (par.rs:414-421).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .. import config as config_mod
from ..errors import Verified
from ..log import info_stats
from ..source import BoundedWorker, FrameBuf, Source, samples_to_le_bytes
from ..component.datatype import Stream

@dataclasses.dataclass
class PipelineStats:
    """Counters reported after a corpus encode (par.rs:414-421 analogue)."""

    files: int = 0
    frames: int = 0
    batches: int = 0
    read_s: float = 0.0         # time inside Source.read_samples
    device_wait_s: float = 0.0  # host blocked on device results (starvation)
    pack_s: float = 0.0         # host frame assembly (C++ packer + routing)
    md5_wait_s: float = 0.0     # waiting on the MD5 thread at finalization
    md5_overdue: int = 0        # producer stalls on the bounded MD5 queue
    tail_frames: int = 0
    max_inflight_batches: int = 0  # boundedness witness (<= pipeline depth)
    wire_batches: Optional[Dict] = None  # {wire format: batch count}
    link_mbps: Optional[float] = None    # rolling link estimate at finish


class _Md5Thread:
    """Dedicated MD5 worker on the shared `source.BoundedWorker`
    (par.rs:196-277); stall counts surface as `stats.md5_overdue`."""

    def __init__(self, stats: PipelineStats):
        self._stats = stats
        self._worker = BoundedWorker(self._handle)

    @staticmethod
    def _handle(item):
        kind, h, payload, n, bytes_per = item
        if kind == 0:       # channel-major block: re-interleave first
            interleaved = np.ascontiguousarray(payload[:, :n].T).reshape(-1)
            h.update(samples_to_le_bytes(interleaved, bytes_per))
        elif kind == 1:     # already-interleaved samples (bulk path)
            h.update(samples_to_le_bytes(payload, bytes_per))
        else:               # raw little-endian PCM bytes (bulk WAV path)
            h.update(payload)

    def submit(self, h, samples: np.ndarray, n: int, bytes_per: int):
        self._worker.submit((0, h, samples, n, bytes_per))

    def submit_interleaved(self, h, samples: np.ndarray, bytes_per: int):
        self._worker.submit((1, h, samples, 0, bytes_per))

    def submit_bytes(self, h, data: bytes):
        self._worker.submit((2, h, data, 0, 0))

    def stop(self):
        """Drains the queue (FIFO) and joins the worker. Idempotent —
        the overdue count is folded into stats exactly once."""
        if not self._worker.stopped:
            self._worker.stop()
            self._stats.md5_overdue += self._worker.overdue

    def check(self):
        self._worker.check()


class _BulkHashCtx:
    """Context-surface adapter handed to `Source.read_blocks_batch` by
    the corpus pipeline: routes the bulk read's hash input to the shared
    `_Md5Thread` (raw WAV bytes hash with ZERO conversion; interleaved
    arrays skip the per-block re-interleave of the fallback path).
    Counters are tracked by the caller, so only the Fill surface exists."""

    def __init__(self, thread: _Md5Thread, h, bytes_per: int):
        self._thread = thread
        self._h = h
        self._bytes_per = bytes_per

    def fill_interleaved(self, a: np.ndarray, copy: bool = True,
                         blocks: int = 1) -> None:
        del blocks  # counters are tracked by the corpus caller
        if copy:
            a = np.array(a, dtype=np.int32, copy=True)
        self._thread.submit_interleaved(self._h, a, self._bytes_per)

    def fill_le_bytes(self, data: bytes, bytes_per: int,
                      blocks: int = 1) -> None:
        del blocks  # counters are tracked by the corpus caller
        self._thread.submit_bytes(self._h, bytes(data))


def encode_corpus(
    sources: Sequence[Tuple[str, Source]],
    config: Verified[config_mod.Encoder] | config_mod.Encoder,
    block_size: int,
    batch_size: int = 64,
    packer: str = "auto",
    mesh="auto",
    strict_lpc: Optional[bool] = None,
) -> Tuple[Dict[str, Stream], PipelineStats]:
    """Encodes many sources, streaming blocks into shared device batches.

    All sources must share (channels, bits_per_sample); sample rates may
    differ (the rate only affects frame headers; batches are grouped per
    rate). Memory stays bounded by the pipeline depth regardless of corpus
    size. `mesh` shards batches across local devices and `strict_lpc` (or
    env FLACENC_STRICT_LPC=1) selects reference-stable float semantics,
    both exactly like `batch_encoder.encode_with_fixed_block_size` (the
    batching/dispatch machinery is shared: `batch_encoder.BatchPipeline`).
    Returns {name: Stream} plus pipeline stats.
    """
    import os

    from ..models import batch_encoder as be
    from ..models import reference_encoder as ref

    explicit_strict = strict_lpc is True
    if strict_lpc is None:
        strict_lpc = os.environ.get("FLACENC_STRICT_LPC", "") == "1"
    cfg = config.inner if isinstance(config, Verified) else config
    if cfg.subframe_coding.qlpc.use_direct_mse:
        if explicit_strict:
            raise ValueError(
                "strict_lpc covers the autocorrelation method; the "
                "experimental direct-MSE/IRLS estimators have no strict "
                "float path"
            )
        strict_lpc = False  # env-derived: documented default semantics
    stats = PipelineStats(files=len(sources))
    if not sources:
        return {}, stats

    nch = sources[0][1].channels()
    bps = sources[0][1].bits_per_sample()
    for name, src in sources:
        if (src.channels(), src.bits_per_sample()) != (nch, bps):
            raise ValueError(
                "corpus sources must share channel count and "
                f"bits-per-sample: {name!r} has "
                f"(channels={src.channels()}, bps={src.bits_per_sample()}) "
                f"vs (channels={nch}, bps={bps})"
            )
    bytes_per = -(-bps // 8)

    # per-file state
    frames_by_file: List[Dict[int, "Frame"]] = [dict() for _ in sources]
    n_full: List[int] = [0] * len(sources)
    tails: List[Optional[np.ndarray]] = [None] * len(sources)
    md5s = [__import__("hashlib").md5() for _ in sources]
    total_samples = [0] * len(sources)

    md5_thread = _Md5Thread(stats)
    pipe = be.BatchPipeline(
        cfg, nch, bps, block_size, batch_size, packer, strict_lpc, mesh
    )
    # pending blocks grouped by sample rate (frame headers encode it)
    pending: Dict[int, List[Tuple[int, int, np.ndarray]]] = {}

    def route(result):
        if result is None:
            return
        for (fi, bi, _), frame in zip(result.cookie, result.frames):
            frames_by_file[fi][bi] = frame
        stats.device_wait_s += result.device_wait_s
        stats.pack_s += result.pack_s
        stats.batches += 1
        stats.max_inflight_batches = max(
            stats.max_inflight_batches, pipe.max_inflight
        )

    def submit(rate: int):
        items = pending.pop(rate)
        route(pipe.submit(
            [it[2] for it in items],
            np.asarray([it[1] for it in items]),
            rate=rate, cookie=items,
        ))

    try:
        for fi, (name, src) in enumerate(sources):
            rate = src.sample_rate()
            framebuf = FrameBuf(nch, block_size)
            # bulk fast path: whole (k, C, T) batches with one hash
            # submit and one deinterleave (see Source.read_blocks_batch);
            # the per-block loop below finishes the ragged tail
            bulk_ctx = _BulkHashCtx(md5_thread, md5s[fi], bytes_per)
            while True:
                t0 = time.perf_counter()
                chunk = src.read_blocks_batch(batch_size, block_size,
                                              bulk_ctx)
                stats.read_s += time.perf_counter() - t0
                if chunk is None:
                    break
                k = chunk.shape[0]
                total_samples[fi] += k * block_size
                if k == batch_size and not pending.get(rate):
                    # aligned fast path: the bulk chunk IS one device
                    # batch — hand the (B, C, T) array straight to the
                    # pipeline (the stream path's zero-restack route;
                    # the per-row pending loop below re-stacks ~8 MB per
                    # batch on this 1-core host)
                    bi0 = n_full[fi]
                    n_full[fi] += k
                    route(pipe.submit(
                        chunk,
                        np.arange(bi0, bi0 + k),
                        rate=rate,
                        cookie=[(fi, bi0 + i, None) for i in range(k)],
                    ))
                else:
                    for i in range(k):
                        pending.setdefault(rate, []).append(
                            (fi, n_full[fi], chunk[i])
                        )
                        n_full[fi] += 1
                        if len(pending[rate]) == batch_size:
                            submit(rate)
                if k < batch_size:
                    break
            while True:
                t0 = time.perf_counter()
                read = src.read_samples(block_size, framebuf)
                stats.read_s += time.perf_counter() - t0
                if read == 0:
                    break
                block = framebuf.samples[:, :read].copy()
                total_samples[fi] += read
                md5_thread.submit(md5s[fi], block, read, bytes_per)
                if read == block_size:
                    pending.setdefault(rate, []).append((fi, n_full[fi], block))
                    n_full[fi] += 1
                    if len(pending[rate]) == batch_size:
                        submit(rate)
                else:
                    # short read = final (tail) block of this source
                    tails[fi] = block
                    break
        for rate in list(pending):
            submit(rate)
        for result in pipe.drain_all():
            route(result)
    finally:
        pipe.close()
        stats.wire_batches = dict(pipe.wire_counts)
        stats.link_mbps = pipe._est.mbps
        t0 = time.perf_counter()
        md5_thread.stop()
        stats.md5_wait_s += time.perf_counter() - t0
        md5_thread.check()

    results: Dict[str, Stream] = {}
    for fi, (name, src) in enumerate(sources):
        stream = Stream(src.sample_rate(), nch, bps)
        for i in range(n_full[fi]):
            stream.add_frame(frames_by_file[fi][i])
            stats.frames += 1
        if tails[fi] is not None:
            tail = tails[fi]
            fb = FrameBuf(nch, tail.shape[1])
            fb.fill_interleaved(
                np.ascontiguousarray(tail.T).reshape(-1)
            )
            stream.add_frame(
                ref.encode_fixed_size_frame(
                    cfg, fb, n_full[fi], stream.stream_info(),
                    strict_lpc=strict_lpc,
                )
            )
            stats.frames += 1
            stats.tail_frames += 1
        if stream.frame_count() > 0:
            mx = stream.stream_info().max_block_size
            stream.stream_info_mut().set_block_sizes(mx, mx)
        stream.stream_info_mut().set_md5_digest(md5s[fi].digest())
        hint = src.len_hint()
        stream.stream_info_mut().set_total_samples(
            hint if hint is not None else total_samples[fi]
        )
        results[name] = stream

    info_stats(
        event="corpus_encode",
        files=stats.files,
        frames=stats.frames,
        batches=stats.batches,
        read_s=round(stats.read_s, 4),
        device_wait_s=round(stats.device_wait_s, 4),
        pack_s=round(stats.pack_s, 4),
        md5_wait_s=round(stats.md5_wait_s, 4),
        md5_overdue=stats.md5_overdue,
        tail_frames=stats.tail_frames,
        max_inflight_batches=stats.max_inflight_batches,
        wire_batches={repr(k): v for k, v in (stats.wire_batches or {}).items()},
        link_mbps=round(stats.link_mbps, 1) if stats.link_mbps else None,
    )
    return results, stats

"""Benchmark: x-realtime FLAC encode on one accelerator (16-bit/44.1 kHz
stereo, block=4096, default config — the reference's headline
configuration).

Prints one JSON line:
  {"metric": ..., "value": N, "unit": "x_realtime", "vs_baseline": N,
   "extra": {...device, card, stage split...}}

The run needs an accelerator: on a CPU-only JAX backend it exits non-zero
without a result line, and any failure during the run propagates as a
non-zero exit.

Baseline: flacenc-rs default (8 threads, nightly SIMD) = 1309.5x realtime
on a GCE c2-standard-8 (BASELINE.md) — context, not a claim.

Methodology:
- `value` is end-to-end wall time, best of `BENCH_TRIALS`: host PCM in
  RAM -> FLAC bytes, including upload, the jitted search program, the
  decisions download, and the C++ residual recompute + bit packing.
- `host_ceiling_x_realtime` = audio_s / (wall_s - device_wait_s): the
  throughput if the device were free.
- `device_step_ms_per_batch` times the jitted device program alone by
  chaining dispatches and blocking on the last output (one device stream
  runs in order).
- `ref_bits_per_sample_same_corpus` encodes the identical signal through
  strict mode (reference-stable float semantics; DESIGN.md), the
  same-inputs methodology of the reference's pytools/reporter.py:27-73.

Usage: python bench.py   (env BENCH_SECONDS, BENCH_BATCH, BENCH_TRIALS)
"""

import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np

BASELINE_X_REALTIME = 1309.5
METRIC = "x-realtime encode per chip (16/44.1 stereo, block=4096)"


def _emit(value: float, extra: dict) -> None:
    """Print one self-contained result line."""
    print(json.dumps({
        "metric": METRIC,
        "value": round(value, 1),
        "unit": "x_realtime",
        "vs_baseline": round(value / BASELINE_X_REALTIME, 4),
        "extra": extra,
    }), flush=True)


def make_audio(seconds: float, rate: int = 44100, seed: int = 1234) -> np.ndarray:
    """Realistic-ish stereo program material: multi-partial tones + noise
    floor + slow amplitude modulation (keeps all predictor paths busy)."""
    n = int(seconds * rate)
    t = np.arange(n, dtype=np.float64) / rate
    rng = np.random.default_rng(seed)
    chans = []
    for ch in range(2):
        sig = np.zeros(n)
        for f0, amp in ((220.0 + 3 * ch, 0.30), (440.0, 0.18), (881.5, 0.09),
                        (1763.0, 0.05), (3526.0, 0.02)):
            sig += amp * np.sin(2 * np.pi * f0 * t + ch + rng.uniform(0, 6.28))
        sig *= 0.6 + 0.4 * np.sin(2 * np.pi * 0.3 * t + ch)
        sig += 0.003 * rng.standard_normal(n)  # ~ -50 dB noise floor
        chans.append(np.clip(np.round(sig * 20000.0), -32768, 32767).astype(np.int32))
    interleaved = np.empty(2 * n, dtype=np.int32)
    interleaved[0::2] = chans[0]
    interleaved[1::2] = chans[1]
    return interleaved


def card_info() -> str:
    """The card's name and power limit as nvidia-smi reports them
    (`name, power.limit`); every timing is printed beside it."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip()


def require_accelerator():
    """The first JAX device; raises when JAX found no accelerator (a
    measurement never falls back to the CPU)."""
    import jax

    dev = jax.devices()[0]
    if dev.platform == "cpu":
        raise RuntimeError("JAX found no accelerator (platform 'cpu')")
    return dev


def _stage_extras(stats, n_samples, rate):
    """Host/device stage breakdown extras from an encode stats dict."""
    if not stats:
        return {}
    wall = stats.get("wall_s", 0.0)
    dev = stats.get("device_wait_s", 0.0)
    # frame assembly runs on io threads (overlapping device waits), so its
    # CPU cost is inside device_wait_s when the device binds; the host
    # ceiling (throughput if the device were free) charges it back
    host = max(wall - dev + stats.get("pack_s", 0.0), 1e-9)
    return {
        "wall_s": round(wall, 3),
        "read_md5_s": round(stats.get("read_s", 0.0), 3),
        # submit_s spans verify + wire prep + upload issue + any drains
        # it triggered (so it OVERLAPS device_wait_s/host_pack_s)
        "submit_s": round(stats.get("submit_s", 0.0), 3),
        "host_pack_s": round(stats.get("pack_s", 0.0), 3),
        "device_wait_s": round(dev, 3),
        "host_ceiling_x_realtime": round((n_samples / rate) / host, 1),
        "batches": stats.get("batches"),
        "grouped_batches": stats.get("grouped_batches"),
        "link_mbps": stats.get("link_mbps"),
    }


def device_step_ms(fn, args, reps: int = 50) -> float:
    """ms per call of a jitted `fn(*args)`: `reps` chained dispatches,
    blocking on every output once the last was issued."""
    import jax

    jax.block_until_ready(fn(*args))  # compile + warm
    t0 = time.perf_counter()
    outs = [fn(*args) for _ in range(reps)]
    jax.block_until_ready(outs)
    return (time.perf_counter() - t0) / reps * 1e3


def main() -> int:
    dev = require_accelerator()
    import jax
    import jax.numpy as jnp

    from flacenc_tpu import config
    from flacenc_tpu.models import batch_encoder as be
    from flacenc_tpu.source import MemSource

    card = card_info()
    rate, bps, block = 44100, 16, 4096
    seconds = float(os.environ.get("BENCH_SECONDS", "600"))
    batch = int(os.environ.get("BENCH_BATCH", "256"))
    trials = int(os.environ.get("BENCH_TRIALS", "3"))
    cfg = config.Encoder().into_verified()

    # warm-up: compile the device program and load the native packer
    warm = make_audio(30.0, rate)
    be.encode_with_fixed_block_size(
        cfg, MemSource(warm, 2, bps, rate), block, batch_size=batch,
    )

    audio = make_audio(seconds, rate)
    n_samples = len(audio) // 2
    best, stats, data, all_x = None, {}, b"", []
    for _ in range(trials):
        trial_stats = {}
        t0 = time.perf_counter()
        stream = be.encode_with_fixed_block_size(
            cfg, MemSource(audio, 2, bps, rate), block, batch_size=batch,
            stats=trial_stats,
        )
        data = stream.to_bytes()
        elapsed = time.perf_counter() - t0
        all_x.append((n_samples / rate) / elapsed)
        if best is None or elapsed < best:
            best, stats = elapsed, trial_stats

    strict = be.encode_with_fixed_block_size(
        cfg, MemSource(audio, 2, bps, rate), block, batch_size=batch,
        strict_lpc=True,
    ).to_bytes()

    fn = be._cached_encoder_fn(
        cfg.inner.to_toml(), 2, bps, block, decisions_only=True
    )
    dev_batch = min(batch, n_samples // block)
    blocks = jnp.asarray(
        audio[: dev_batch * block * 2].reshape(dev_batch, block, 2)
        .transpose(0, 2, 1).astype(np.int16)
    )
    step_ms = device_step_ms(fn, (blocks,))

    _emit((n_samples / rate) / best, dict(
        device={"platform": dev.platform, "kind": dev.device_kind,
                "count": len(jax.devices())},
        card=card,
        seconds_encoded=seconds, batch=batch,
        trials_x_realtime=[round(x, 1) for x in all_x],
        bits_per_sample=round(len(data) * 8 / len(audio), 4),
        ref_bits_per_sample_same_corpus=round(len(strict) * 8 / len(audio), 4),
        device_step_ms_per_batch=round(step_ms, 3),
        device_step_batch=dev_batch,
        wire_batches=stats.get("wire_batches"),
        **_stage_extras(stats, n_samples, rate),
    ))
    return 0


if __name__ == "__main__":
    sys.exit(main())

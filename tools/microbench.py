"""Per-kernel microbenchmarks (the reference's ``#[bench]`` suite analogue).

Timing methodology: each kernel is dispatched in chains of two lengths with
ONE fetch of the last (tiny, summed) output — the device executes one
stream in order, so the last result bounds the chain — and the difference
removes the fixed per-fetch latency.

Run:
    python tools/microbench.py [--batch 128] [--block 4096]
"""

from __future__ import annotations

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--block", type=int, default=4096)
    ap.add_argument("--reps", type=int, default=40)
    args = ap.parse_args()
    B, T, reps = args.batch, args.block, args.reps

    import jax
    import jax.numpy as jnp

    from flacenc_tpu import config
    from flacenc_tpu.config import Window
    from flacenc_tpu.ops import fixed as oF, lpc as oL, rice as oR
    from flacenc_tpu.ops.windows import get_window

    rng = np.random.default_rng(0)
    sig = jnp.asarray(rng.integers(-(1 << 14), 1 << 14, (B, 4, T), np.int32))
    win = get_window(Window(), T)
    warm = jnp.full((B, 4), 10, jnp.int32)

    def bench(name, fn, *fargs):
        f = jax.jit(lambda *a: jax.tree.map(lambda x: x.sum(), fn(*a)))
        jax.device_get(f(*fargs))  # compile + warm
        ts = {}
        for n in (10, 10 + reps):
            t0 = time.perf_counter()
            outs = [f(*fargs) for _ in range(n)]
            jax.device_get(outs[-1])
            ts[n] = time.perf_counter() - t0
        dt = max((ts[10 + reps] - ts[10]) / reps, 1e-9)
        per_frame_us = dt / B * 1e6
        print(f"{name:34s} {dt*1e3:8.3f} ms/batch  {per_frame_us:8.2f} us/frame")

    print(f"# device kernels (batch={B}, 4 candidate channels, T={T}, "
          f"chained x{reps})")
    bench("fixed_lpc_errors (5 orders)", oF.fixed_lpc_errors, sig)
    bench("estimate_entropy x5", lambda s: [
        oF.estimate_entropy(s, warm, 16, T) for _ in range(5)
    ], sig)
    bench("windowing f32", lambda s: oL.apply_window(s, win), sig)
    bench("autocorr f64 (order 10)",
          lambda s: oL.auto_correlation(oL.apply_window(s, win), 10), sig)
    bench("+levinson f64 (order 10)",
          lambda s: oL.levinson(oL.auto_correlation(oL.apply_window(s, win), 10), 10), sig)
    qc = jnp.asarray(rng.integers(-16000, 16000, (B, 4, 24), np.int32))
    order = jnp.full((B, 4), 10, jnp.int32)
    shift = jnp.full((B, 4), 12, jnp.int32)
    bench("compute_error i64 FIR (10 taps)",
          lambda *a: oL.compute_error(*a, max_taps=10), qc, order, shift, sig)
    bench("rice search (full)", lambda e: oR.find_partitioned_rice_parameters(
        e, warm, T, 30), sig)
    bench("direct-MSE LPC (order 10)",
          lambda s: oL.lpc_direct_mse(oL.apply_window(s, win), 10), sig)

    from flacenc_tpu import native
    from flacenc_tpu.models import batch_encoder as be

    cfg = config.Encoder()
    fn = be._cached_encoder_fn(cfg.to_toml(), 2, 16, T, decisions_only=True)
    blocks = rng.integers(-(1 << 14), 1 << 14, (B, 2, T), np.int32)
    dblocks = jnp.asarray(blocks.astype(np.int16))
    jax.device_get(fn(dblocks))  # one coalesced decisions buffer
    ts = {}
    for n in (10, 10 + reps):
        t0 = time.perf_counter()
        outs = [fn(dblocks) for _ in range(n)]
        jax.device_get(outs[-1])
        ts[n] = time.perf_counter() - t0
    dt = max((ts[10 + reps] - ts[10]) / reps, 1e-9)
    print(f"{'FULL encode step (decisions)':34s} {dt*1e3:8.3f} ms/batch  "
          f"{(B*T/44100)/dt:8.0f} x realtime")

    # host-side stages (single core)
    if native.available():
        enc = be.split_decisions(np.asarray(jax.device_get(fn(dblocks))), 2)
        t0 = time.perf_counter()
        be.pack_frames_decisions(enc, blocks, np.arange(B), cfg, 2, 16, 44100, T)
        dt = time.perf_counter() - t0
        print(f"\n# host packer (decisions recompute): {dt*1e3:.2f} ms/batch "
              f"({B*T/44100/dt:.0f}x realtime standalone)")

    import hashlib

    pcm = blocks.astype("<i2").tobytes()
    t0 = time.perf_counter()
    hashlib.md5(pcm).digest()
    dt = time.perf_counter() - t0
    print(f"# md5: {len(pcm)/dt/1e6:.0f} MB/s")
    return 0


if __name__ == "__main__":
    sys.exit(main())

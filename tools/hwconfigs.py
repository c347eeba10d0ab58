"""Hardware measurement of the BASELINE.json config matrix (VERDICT r3 #4).

Measures x-realtime + bits/sample for every north-star config on the
current default backend:

1. fixed-only  — mono sigen sine+noise, 16/44.1, use_lpc=false
                 (the reference's st.config.toml-like path)
2. default     — stereo CD audio, QLPC + full stereo search
                 (bench.py's headline config, repeated here for one
                 self-consistent table)
3. hi-res      — 24-bit/96 kHz stereo (exercises the round-3 wide
                 wires + i32 side-channel residuals)
4. experimental— direct-MSE LPC (the reference's `experimental` feature)
5. corpus      — track-length files through parallel.encode_corpus
                 (the par.rs replacement path; files > 1 device batch
                 exercise the aligned bulk fast path)

Emits one JSON line per config and writes report/hardware_configs.md.
Usage: python tools/hwconfigs.py [--seconds 120] [--out report/hardware_configs.md]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def stereo_audio(seconds: float, rate: int, bps: int) -> np.ndarray:
    from bench import make_audio

    if bps == 16 and rate == 44100:
        return make_audio(seconds, rate)
    n = int(seconds * rate)
    t = np.arange(n, dtype=np.float64) / rate
    rng = np.random.default_rng(99)
    full = (1 << (bps - 1)) - 1
    chans = []
    for ch in range(2):
        sig = np.zeros(n)
        for f0, amp in ((196.0 + 5 * ch, 0.3), (392.0, 0.15), (784.5, 0.07),
                        (1569.0, 0.03)):
            sig += amp * np.sin(2 * np.pi * f0 * t + ch + rng.uniform(0, 6.28))
        sig *= 0.6 + 0.4 * np.sin(2 * np.pi * 0.25 * t + ch)
        sig += (2.0 ** -(bps - 6)) * rng.standard_normal(n)
        chans.append(
            np.clip(np.round(sig * 0.6 * full), -full - 1, full).astype(np.int64)
        )
    out = np.empty(2 * n, np.int32)
    out[0::2] = chans[0]
    out[1::2] = chans[1]
    return out


def mono_audio(seconds: float, rate: int = 44100) -> np.ndarray:
    from flacenc_tpu import sigen

    n = int(seconds * rate)
    return np.asarray(
        sigen.Sine(220, 0.4).noise_with_seed(3, 0.04).to_vec_quantized(16, n),
        np.int32,
    )


def timed_encode(cfg, audio, ch, bps, rate, block, batch, trials=3):
    from flacenc_tpu.models import batch_encoder as be
    from flacenc_tpu.source import MemSource

    # the warm-up encode only STARTS the packed-wire background compiles
    # (tens of seconds on remote-compile backends): block on them, then
    # run one untimed SETTLE encode so the racer probes and measures the
    # now-warm wires — otherwise a 120 s-audio row (~26 batches) ends
    # before the racer can flip off raw and the matrix mis-attributes
    # the wire choice (r5: the hi-res row shipped raw int32 this way)
    be.wait_all_warms(timeout=360)  # never raises
    be.encode_with_fixed_block_size(
        cfg, MemSource(audio, ch, bps, rate), block, batch_size=batch
    )
    be.wait_all_warms(timeout=360)

    best, data = None, b""
    stats = {}
    for i in range(trials):
        if i:
            time.sleep(10)
        src = MemSource(audio, ch, bps, rate)
        trial_stats = {}
        t0 = time.perf_counter()
        stream = be.encode_with_fixed_block_size(
            cfg, src, block, batch_size=batch, stats=trial_stats
        )
        data = stream.to_bytes()
        dt = time.perf_counter() - t0
        if best is None or dt < best:
            best, stats = dt, trial_stats
    n_samples = len(audio) // ch
    wires = stats.get("wire_batches") or {}
    return {
        "x_realtime": round((n_samples / rate) / best, 1),
        "bits_per_sample": round(len(data) * 8 / len(audio), 4),
        "device_wait_s": round(stats.get("device_wait_s", 0.0), 3),
        "host_pack_s": round(stats.get("pack_s", 0.0), 3),
        "wall_s": round(best, 3),
        "audio_s": round(n_samples / rate, 1),
        # dominant upload wire of the best trial (the racer's verdict) —
        # attribution for upload-bound rows (VERDICT r4 #5)
        "wire": (max(wires, key=wires.get) if wires else "?"),
        "link_mbps": stats.get("link_mbps"),
    }


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seconds", type=float, default=120.0)
    ap.add_argument("--out", default="report/hardware_configs.md")
    ap.add_argument("--skip", default="", help="comma-separated config names")
    args = ap.parse_args()

    import jax

    from flacenc_tpu import config
    from flacenc_tpu.source import MemSource

    skip = set(filter(None, args.skip.split(",")))
    backend = jax.default_backend()
    rows = {}

    def write_markdown():
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            f.write("# Hardware config matrix (BASELINE.json north-star configs)\n\n")
            f.write(f"Backend: `{backend}` ({len(jax.devices())} device(s)); "
                    f"{args.seconds:.0f}s of audio per config "
                    f"(best-of-3 trials after wire-warm + settle), batch 256, block 4096.\n\n")
            f.write("| config | x realtime | bits/sample | device_wait_s | "
                    "host_pack_s | wall_s | audio_s | wire | link MB/s |\n"
                    "|---|---|---|---|---|---|---|---|---|\n")
            for name, r in rows.items():
                if "error" in r:
                    f.write(f"| {name} | FAILED | | | | | | | |"
                            f"  <!-- {r['error']} -->\n")
                    continue
                f.write(
                    f"| {name} | {r['x_realtime']} | {r['bits_per_sample']} "
                    f"| {r.get('device_wait_s', '')} | {r.get('host_pack_s', '')} "
                    f"| {r['wall_s']} | {r['audio_s']} "
                    f"| `{r.get('wire', '')}` | {r.get('link_mbps', '')} |\n"
                )
            f.write(
                "\nReference context (different hardware, real-music corpus — "
                "NOT directly\ncomparable on compression): flacenc-rs default "
                "mt 1309.5x / st 331.5x /\nexperimental 212.3x on a GCE "
                "c2-standard-8 (BASELINE.md).\n"
            )


    def run(name, fn):
        if name in skip:
            return
        t0 = time.perf_counter()
        try:
            rows[name] = fn()
        except Exception as e:  # noqa: BLE001 — isolate per-config failures
            # keep the completed rows and say which config failed
            rows[name] = {"x_realtime": 0.0, "bits_per_sample": 0.0,
                          "wall_s": 0.0, "audio_s": 0.0,
                          "error": f"{type(e).__name__}: {e}"[:200]}
        rows[name]["setup_plus_run_s"] = round(time.perf_counter() - t0, 1)
        print(json.dumps({"config": name, **rows[name]}), flush=True)
        write_markdown()  # incremental: a later crash keeps earlier rows

    # 1. fixed-only, mono (st path)
    def fixed_only():
        c = config.Encoder()
        c.subframe_coding.use_lpc = False
        cfg = c.into_verified()
        from flacenc_tpu.models import batch_encoder as be

        warm = mono_audio(20.0)
        be.encode_with_fixed_block_size(
            cfg, MemSource(warm, 1, 16, 44100), 4096, batch_size=256
        )
        return timed_encode(
            cfg, mono_audio(args.seconds), 1, 16, 44100, 4096, 256
        )

    run("fixed-only (mono 16/44.1)", fixed_only)

    # 2. default stereo CD (the headline; bench.py measures this too)
    def default_cd():
        cfg = config.Encoder().into_verified()
        from flacenc_tpu.models import batch_encoder as be

        warm = stereo_audio(20.0, 44100, 16)
        be.encode_with_fixed_block_size(
            cfg, MemSource(warm, 2, 16, 44100), 4096, batch_size=256
        )
        return timed_encode(
            cfg, stereo_audio(args.seconds, 44100, 16), 2, 16, 44100, 4096, 256
        )

    run("default (stereo 16/44.1)", default_cd)

    # 3. hi-res 24/96 stereo
    def hires():
        cfg = config.Encoder().into_verified()
        from flacenc_tpu.models import batch_encoder as be

        warm = stereo_audio(10.0, 96000, 24)
        be.encode_with_fixed_block_size(
            cfg, MemSource(warm, 2, 24, 96000), 4096, batch_size=256
        )
        return timed_encode(
            cfg, stereo_audio(args.seconds, 96000, 24), 2, 24, 96000, 4096, 256
        )

    run("hi-res (stereo 24/96)", hires)

    # 4. experimental direct-MSE
    def experimental():
        c = config.Encoder()
        c.subframe_coding.qlpc.use_direct_mse = True
        cfg = c.into_verified()
        from flacenc_tpu.models import batch_encoder as be

        warm = stereo_audio(10.0, 44100, 16)
        be.encode_with_fixed_block_size(
            cfg, MemSource(warm, 2, 16, 44100), 4096, batch_size=256
        )
        return timed_encode(
            cfg, stereo_audio(min(args.seconds, 60.0), 44100, 16),
            2, 16, 44100, 4096, 256,
        )

    run("experimental (direct-MSE)", experimental)

    # 5. corpus encode through the par-mode replacement
    def corpus():
        from flacenc_tpu.models import batch_encoder as be
        from flacenc_tpu.parallel import encode_corpus

        cfg = config.Encoder().into_verified()
        # 4 track-length files (30 s each at --seconds 120): a real
        # corpus is albums, not jingles — files longer than one device
        # batch (23.8 s at 256x4096) exercise the aligned bulk fast
        # path (full (B,C,T) chunks straight to the pipeline) with the
        # ragged tails going through the per-row pending loop
        n_files = 4
        per_file = max(args.seconds / n_files, 4.0)
        base = stereo_audio(per_file * n_files, 44100, 16)
        n_file = (len(base) // n_files) // 2 * 2
        sources = []
        total_samples = 0
        for i in range(n_files):
            chunk = base[i * n_file: (i + 1) * n_file]
            sources.append((f"f{i:02d}", MemSource(chunk, 2, 16, 44100)))
            total_samples += len(chunk) // 2
        # warmup on a tiny corpus (compiles shared with the stream path)
        warm = [(f"w{i}", MemSource(base[: 44100 * 4], 2, 16, 44100))
                for i in range(2)]
        encode_corpus(warm, cfg, 4096, batch_size=256)
        be.wait_all_warms(timeout=360)
        dt, streams, stats = None, {}, None
        for i in range(3):
            if i:
                time.sleep(10)
            sources2 = [(n, MemSource(s.interleaved(), 2, 16, 44100))
                        for n, s in sources]
            t0 = time.perf_counter()
            streams_i, stats_i = encode_corpus(
                sources2, cfg, 4096, batch_size=256)
            dt_i = time.perf_counter() - t0
            if dt is None or dt_i < dt:
                dt, streams, stats = dt_i, streams_i, stats_i
        total_bytes = sum(len(s.to_bytes()) for s in streams.values())
        wires = {repr(k): v for k, v in (stats.wire_batches or {}).items()}
        return {
            "x_realtime": round((total_samples / 44100) / dt, 1),
            "bits_per_sample": round(total_bytes * 8 / (2 * total_samples), 4),
            "files": len(streams),
            "device_wait_s": round(stats.device_wait_s, 3),
            "host_pack_s": round(stats.pack_s, 3),
            "wall_s": round(dt, 3),
            "audio_s": round(total_samples / 44100, 1),
            "wire": (max(wires, key=wires.get) if wires else "?"),
            "link_mbps": (round(stats.link_mbps, 1)
                          if stats.link_mbps else None),
        }

    run("corpus (4 track-length files, stereo 16/44.1)", corpus)

    # run() wrote the file incrementally after each config
    print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

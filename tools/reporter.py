"""Benchmark report generator (the ``pytools/reporter.py`` analogue).

Encodes a generated test corpus under several configs (default / oracle
single-stream / fixed-only / experimental direct-MSE), measures wall time
and sizes, verifies every output decodes sample-exact through the
independent parser, and emits a markdown report mirroring the reference's
`report/report.*.md` format (average compression rate + inverse RTF).

Usage: python tools/reporter.py [-o report.md] [--seconds 20]
"""

from __future__ import annotations

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

from flacenc_tpu import config
from flacenc_tpu.component import decode_stream, parse_stream
from flacenc_tpu.source import MemSource


def make_corpus(seconds: float, rate: int = 44100):
    """Four synthetic stereo programs with different spectral character."""
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    from bench import make_audio

    n = int(seconds * rate)
    rng = np.random.default_rng(7)
    corpus = {}
    corpus["tonal"] = make_audio(seconds, rate)
    t = np.arange(n) / rate
    # noisy percussive-ish
    env = (np.sin(2 * np.pi * 2.1 * t) ** 8)
    noise = rng.standard_normal(n) * env * 0.4
    x = np.clip(np.round(noise * 26000), -32768, 32767).astype(np.int32)
    interleaved = np.empty(2 * n, np.int32)
    interleaved[0::2] = x
    interleaved[1::2] = np.roll(x, 17)
    corpus["percussive"] = interleaved
    # quiet ambient
    amb = (
        0.05 * np.sin(2 * np.pi * 55 * t)
        + 0.02 * np.sin(2 * np.pi * 110.3 * t)
        + 0.001 * rng.standard_normal(n)
    )
    x = np.clip(np.round(amb * 32000), -32768, 32767).astype(np.int32)
    interleaved = np.empty(2 * n, np.int32)
    interleaved[0::2] = x
    interleaved[1::2] = x + rng.integers(-2, 3, n)
    corpus["ambient"] = interleaved
    # near-silence with clicks
    x = np.zeros(n, np.int32)
    idx = rng.integers(0, n, 50)
    x[idx] = rng.integers(-30000, 30000, 50)
    interleaved = np.empty(2 * n, np.int32)
    interleaved[0::2] = x
    interleaved[1::2] = x
    corpus["sparse"] = interleaved
    return corpus


RESOURCE_DIR = "/root/reference/src/resource"
REAL_SIGNALS = ("sus109", "sus6", "ras22", "ras103")


def load_real_corpus():
    """The reference's embedded real-audio test signals (16-bit stereo,
    test_helper.rs:81-125) — the overlapping-material anchor that makes
    compression rates comparable to reference-built streams (the
    synthetic corpus is NOT comparable to wikimedia-WAV numbers)."""
    if not os.path.isdir(RESOURCE_DIR):
        return {}
    corpus = {}
    for name in REAL_SIGNALS:
        chans = []
        for ch in (0, 1):
            path = os.path.join(RESOURCE_DIR, f"testsignal.{name}.ch{ch}.bin")
            with open(path, "rb") as f:
                chans.append(
                    np.frombuffer(f.read(), dtype="<i2").astype(np.int32)
                )
        x = np.empty(2 * len(chans[0]), np.int32)
        x[0::2], x[1::2] = chans
        corpus[name] = x
    return corpus


def encoder_configs():
    cfgs = {}
    cfgs["default"] = (config.Encoder(), True)
    cfgs["st (oracle, scalar)"] = (config.Encoder(), False)
    c = config.Encoder()
    c.subframe_coding.use_lpc = False
    cfgs["fixed-only"] = (c, True)
    c = config.Encoder()
    c.subframe_coding.qlpc.use_direct_mse = True
    cfgs["experimental (direct-MSE)"] = (c, True)
    return cfgs


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("-o", "--output", default="report/report.md")
    ap.add_argument("--seconds", type=float, default=20.0)
    args = ap.parse_args()

    import flacenc_tpu

    rate = 44100
    corpus = make_corpus(args.seconds, rate)
    rows = []
    for name, (cfg, use_device) in encoder_configs().items():
        verified = cfg.into_verified()
        total_in = total_out = 0
        total_ref_out = 0  # strict-proxy: reference-stable byte semantics
        total_audio_s = total_wall = 0.0
        # warm up compile + first-execution outside the timed region
        warm = next(iter(corpus.values()))[: 44100 * 4]
        flacenc_tpu.encode_with_fixed_block_size(
            verified, MemSource(warm, 2, 16, rate), cfg.block_size,
            use_device=use_device, batch_size=256,
        )
        for cname, interleaved in corpus.items():
            wall = None
            for _trial in range(2):  # best-of-2
                src = MemSource(interleaved, 2, 16, rate)
                t0 = time.perf_counter()
                stream = flacenc_tpu.encode_with_fixed_block_size(
                    verified, src, cfg.block_size, use_device=use_device,
                    batch_size=256,
                )
                data = stream.to_bytes()
                t = time.perf_counter() - t0
                wall = t if wall is None else min(wall, t)
            decoded = decode_stream(parse_stream(data))
            assert np.array_equal(decoded, interleaved), f"{name}/{cname} not lossless"
            total_in += len(interleaved) * 2
            total_out += len(data)
            total_audio_s += len(interleaved) / 2 / rate
            total_wall += wall
            if not cfg.subframe_coding.qlpc.use_direct_mse:
                # same-corpus reference proxy: strict mode reproduces the
                # reference STABLE build's float semantics byte-for-byte
                # for this config (bench.py methodology)
                ref_stream = flacenc_tpu.encode_with_fixed_block_size(
                    verified, MemSource(interleaved, 2, 16, rate),
                    cfg.block_size, use_device=use_device, batch_size=256,
                    strict_lpc=True,
                )
                total_ref_out += len(ref_stream.to_bytes())
        ref_rate = total_ref_out / total_in if total_ref_out else None
        rows.append(
            (name, total_out / total_in, total_audio_s / total_wall, ref_rate)
        )
        print(
            f"{name}: rate={rows[-1][1]:.5f} irtf={rows[-1][2]:.1f}x"
            + (f" ref_proxy={ref_rate:.5f}" if ref_rate else ""),
            flush=True,
        )

    # real-audio section: the reference's own embedded signals, the one
    # corpus this image shares with the reference repo (VERDICT r3 #7)
    real = load_real_corpus()
    real_rows = []
    if real:
        verified = config.Encoder().into_verified()
        agg_in = agg_out = agg_ref = 0
        for cname, interleaved in real.items():
            src = MemSource(interleaved, 2, 16, rate)
            stream = flacenc_tpu.encode_with_fixed_block_size(
                verified, src, 4096, batch_size=256,
            )
            data = stream.to_bytes()
            decoded = decode_stream(parse_stream(data))
            assert np.array_equal(decoded, interleaved), f"real/{cname}"
            ref_stream = flacenc_tpu.encode_with_fixed_block_size(
                verified, MemSource(interleaved, 2, 16, rate), 4096,
                batch_size=256, strict_lpc=True,
            )
            nbytes_in = len(interleaved) * 2
            real_rows.append((
                cname, len(data) / nbytes_in,
                len(data) * 8 / len(interleaved),
                len(ref_stream.to_bytes()) / nbytes_in,
            ))
            agg_in += nbytes_in
            agg_out += len(data)
            agg_ref += len(ref_stream.to_bytes())
        real_rows.append((
            "ALL", agg_out / agg_in, agg_out * 8 / (agg_in // 2),
            agg_ref / agg_in,
        ))

    import jax

    os.makedirs(os.path.dirname(args.output) or ".", exist_ok=True)
    with open(args.output, "w") as f:
        f.write("# flacenc-tpu benchmark report\n\n")
        f.write(f"Backend: `{jax.default_backend()}` "
                f"({len(jax.devices())} device(s)).\n")
        f.write(f"Corpus: {len(corpus)} synthetic stereo programs, ")
        f.write(f"{args.seconds:.0f}s each, 16-bit/44.1kHz. All outputs verified\n")
        f.write("sample-exact through the CRC-checking parser.\n\n")
        f.write(
            "**Caveat — synthetic corpus.** These rates are NOT comparable\n"
            "to BASELINE.md's 0.5277, which was measured on real music\n"
            "(wikimedia WAVs, no real-music WAV exists in this image). The\n"
            "like-for-like parity check is the `ref (strict proxy)` column:\n"
            "the SAME corpus encoded with strict reference-stable float\n"
            "semantics, i.e. the bytes the reference's stable build would\n"
            "emit for this config (see DESIGN.md; bench.py methodology).\n\n"
        )
        f.write("## Average compression rate (output/input, lower is better)\n\n")
        f.write("| config | rate | ref (strict proxy) |\n|---|---|---|\n")
        for name, rate_, _, ref_rate in rows:
            ref_s = f"{ref_rate:.5f}" if ref_rate else "n/a (experimental)"
            f.write(f"| {name} | {rate_:.5f} | {ref_s} |\n")
        f.write("\n## Encode speed (inverse RTF, higher is better)\n\n")
        f.write(
            "**Methodology — these are SHORT-CLIP LATENCY numbers, not\n"
            "steady-state throughput.** Each corpus program is "
            f"{args.seconds:.0f} s — one to a\nfew device batches — so "
            "fixed per-stream costs (jit dispatch, transfers, pipeline\n"
            "fill/drain) dominate the wall and the column reads far below\n"
            "the pipeline's steady state. For sustained throughput on long\n"
            "streams see bench.py (600 s audio, warm programs).\n\n"
        )
        f.write("| config | x realtime |\n|---|---|\n")
        for name, _, irtf, _ in rows:
            f.write(f"| {name} | {irtf:.1f} |\n")
        if real_rows:
            f.write(
                "\n## Real audio (reference's embedded test signals)\n\n"
                "The four `testsignal.*` stereo pairs from the reference "
                "repo\n(`src/resource/`, real recordings per "
                "test_helper.rs:81-125) — the only\nreal-audio material "
                "this image shares with the reference. Default config,\n"
                "block 4096; `ref (strict proxy)` is the same corpus with "
                "reference-stable\nfloat semantics (byte-level parity "
                "mode). These streams are also pinned\nas frozen goldens "
                "in tests/test_stream_goldens.py.\n\n"
                "| signal | rate | bits/sample | ref (strict proxy) |\n"
                "|---|---|---|---|\n"
            )
            for cname, rate_, bits, ref_rate in real_rows:
                f.write(f"| {cname} | {rate_:.5f} | {bits:.4f} "
                        f"| {ref_rate:.5f} |\n")
    print(f"wrote {args.output}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

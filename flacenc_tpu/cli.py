"""Command-line interface: `python -m flacenc_tpu.cli encode|decode`.

Mirrors the reference CLI (``/root/reference/flacenc-bin/src/main.rs``):
`encode` is the default subcommand; TOML config load (`--config`) and dump
(`--dump-config`); `decode` parses, optionally dumps the component tree
(`--dump-struct`, msgpack like the reference; `.json` extension switches
to JSON), writes a WAV, and verifies
the stream MD5.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import sys
import time

import numpy as np

from . import config as config_mod
from . import display
from .component import decode_stream, parse_stream
from .errors import FlacencError
from .source import samples_to_le_bytes
from .wav import write_wav

# sysexits-style codes (main.rs:157-170)
EX_USAGE = 64
EX_DATAERR = 65
EX_NOINPUT = 66
EX_SOFTWARE = 70
EX_CANTCREAT = 73
EX_IOERR = 74


def _positive_int(text: str) -> int:
    v = int(text)
    if v < 1:
        raise argparse.ArgumentTypeError(f"must be >= 1 (got {v})")
    return v


def _build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="flacenc", description="FLAC encoder with a batched accelerator search")
    sub = p.add_subparsers(dest="command")

    enc = sub.add_parser("encode", help="encode WAV to FLAC (default)")
    enc.add_argument("source", help="input WAV file")
    enc.add_argument("-o", "--output", required=True, help="output FLAC file")
    enc.add_argument("-c", "--config", help="TOML encoder config")
    enc.add_argument("--dump-config", help="write the effective config TOML here")
    enc.add_argument("--block-size", type=int, default=None)
    enc.add_argument(
        "--batch-size", type=_positive_int, default=None,
        help="blocks per device batch (throughput knob; default 64; "
             "output bytes never change)",
    )
    enc.add_argument(
        "--cpu-only", action="store_true",
        help="run the batched pipeline on the host CPU backend (byte-"
             "identical to the device path, no accelerator needed)",
    )
    enc.add_argument(
        "--oracle", action="store_true",
        help="use the scalar numpy reference encoder (the parity oracle; "
             "~100x slower than --cpu-only's batched pipeline)",
    )
    enc.add_argument(
        "--strict-float", action="store_true",
        help="exact stable-reference float semantics for QLPC estimation "
             "(byte-identical streams to flacenc-rs stable builds)",
    )
    enc.add_argument(
        "--profile-trace", default=None, metavar="DIR",
        help="wrap the encode in a jax.profiler trace written to DIR "
             "(the reference's --pprof-output analogue, main.rs:377-402)",
    )

    corp = sub.add_parser(
        "encode-corpus",
        help="encode many WAVs, batching blocks across files on the device",
    )
    corp.add_argument("sources", nargs="+", help="input WAV files")
    corp.add_argument("-d", "--output-dir", required=True)
    corp.add_argument("-c", "--config", help="TOML encoder config")
    corp.add_argument("--block-size", type=int, default=None)
    corp.add_argument(
        "--batch-size", type=_positive_int, default=None,
        help="blocks per device batch (throughput knob; see encode)",
    )
    corp.add_argument(
        "--strict-float", action="store_true",
        help="exact stable-reference float semantics (see encode)",
    )
    corp.add_argument(
        "--cpu-only", action="store_true",
        help="run the batched pipeline on the host CPU backend (see encode)",
    )

    dec = sub.add_parser("decode", help="decode FLAC to WAV (experimental)")
    dec.add_argument("source", help="input FLAC file")
    dec.add_argument("-o", "--output", required=True, help="output WAV file")
    dec.add_argument(
        "--dump-struct",
        help="dump the parsed component tree (msgpack; .json for JSON)",
    )
    dec.add_argument("--no-verify", action="store_true", help="skip CRC/MD5 checks")
    return p


def _pin_cpu_if_asked(args) -> None:
    """--cpu-only pins the in-process jax platform to cpu before the
    first compile (the batched pipeline runs byte-identically there)."""
    if getattr(args, "cpu_only", False):
        import jax

        jax.config.update("jax_platforms", "cpu")


def _stream_struct(stream) -> dict:
    info = stream.stream_info()
    return {
        "stream_info": {
            "min_block_size": info.min_block_size,
            "max_block_size": info.max_block_size,
            "min_frame_size": info.min_frame_size,
            "max_frame_size": info.max_frame_size,
            "sample_rate": info.sample_rate,
            "channels": info.channels,
            "bits_per_sample": info.bits_per_sample,
            "total_samples": info.total_samples,
            "md5": info.md5.hex(),
        },
        "frames": [
            {
                "frame_number": f.header().frame_number,
                "block_size": f.block_size(),
                "channel_assignment": repr(f.header().channel_assignment),
                "subframes": [type(s).__name__ for s in f.subframes()],
            }
            for f in stream.frames()
        ],
    }


def main_enc(args) -> int:
    import flacenc_tpu

    cfg = config_mod.Encoder()
    if args.config:
        with open(args.config) as f:
            cfg = config_mod.Encoder.from_toml(f.read())
    if args.block_size is not None:
        cfg.block_size = args.block_size
    verified = cfg.into_verified()

    # stream blocks straight from disk (flacenc-bin/src/source.rs:54-133):
    # peak RSS stays ~ pipeline depth x batch bytes however large the input
    from .wav import WavFileSource

    src = WavFileSource(args.source)
    channels, bits, rate = src.channels(), src.bits_per_sample(), src.sample_rate()

    if args.batch_size and args.oracle:
        print(
            "note: --batch-size has no effect with --oracle "
            "(the scalar reference encoder has no device batches)",
            file=sys.stderr,
        )
    if not args.oracle:
        _pin_cpu_if_asked(args)
    t0 = time.perf_counter()

    def run():
        kwargs = {}
        if args.batch_size and not args.oracle:
            kwargs["batch_size"] = args.batch_size
        return flacenc_tpu.encode_with_fixed_block_size(
            verified, src, cfg.block_size, use_device=not args.oracle,
            strict_lpc=True if args.strict_float else None, **kwargs,
        )

    if args.profile_trace:
        # the reference's optional CPU-profiler wrap (main.rs:377-402)
        import jax

        with jax.profiler.trace(args.profile_trace):
            stream = run()
    else:
        stream = run()
    data = stream.to_bytes()
    elapsed = time.perf_counter() - t0
    with open(args.output, "wb") as f:
        f.write(data)
    if args.dump_config:
        with open(args.dump_config, "w") as f:
            f.write(cfg.to_toml())
    n = stream.stream_info().total_samples
    in_bytes = n * channels * (-(-bits // 8))
    display.progress_encoded(
        args.source, args.output, in_bytes, len(data), n / rate, elapsed
    )
    return 0


def main_corpus(args) -> int:
    import os

    from .parallel import encode_corpus
    from .wav import WavFileSource

    cfg = config_mod.Encoder()
    if args.config:
        with open(args.config) as f:
            cfg = config_mod.Encoder.from_toml(f.read())
    if args.block_size is not None:
        cfg.block_size = args.block_size
    verified = cfg.into_verified()

    sources = [(path, WavFileSource(path)) for path in args.sources]
    os.makedirs(args.output_dir, exist_ok=True)
    _pin_cpu_if_asked(args)
    t0 = time.perf_counter()
    corpus_kwargs = {}
    if args.batch_size:
        corpus_kwargs["batch_size"] = args.batch_size
    streams, stats = encode_corpus(
        sources, verified, cfg.block_size,
        strict_lpc=True if args.strict_float else None, **corpus_kwargs,
    )
    wall = time.perf_counter() - t0
    total_in = total_out = 0
    audio_s = 0.0
    for path, src in sources:
        stream = streams[path]
        data = stream.to_bytes()
        name = os.path.splitext(os.path.basename(path))[0] + ".flac"
        with open(os.path.join(args.output_dir, name), "wb") as f:
            f.write(data)
        info = stream.stream_info()
        total_out += len(data)
        total_in += info.total_samples * info.channels * (info.bits_per_sample // 8)
        audio_s += info.total_samples / info.sample_rate
    display.progress_encoded(
        f"{stats.files} files ({stats.frames} frames, {stats.batches} batches)",
        args.output_dir, total_in, total_out, audio_s, wall,
    )
    return 0


def main_dec(args) -> int:
    with open(args.source, "rb") as f:
        data = f.read()
    try:
        stream = parse_stream(data, verify_crc=not args.no_verify)
    except FlacencError as e:
        # parse failures are EX_NOINPUT like the reference
        # (main.rs:283-293), not EX_DATAERR
        display.error(f"failed to parse the source FLAC file: {e}")
        return EX_NOINPUT
    if args.dump_struct:
        tree = _stream_struct(stream)
        if args.dump_struct.endswith(".json"):
            with open(args.dump_struct, "w") as f:
                json.dump(tree, f, indent=1)
        else:
            # rmp-serde msgpack analogue (flacenc-bin/src/main.rs:301-316)
            from .utils import msgpack

            with open(args.dump_struct, "wb") as f:
                f.write(msgpack.packb(tree))
    decoded = decode_stream(stream)
    info = stream.stream_info()
    md5_ok = True
    if not args.no_verify:
        md5 = hashlib.md5(
            samples_to_le_bytes(decoded, -(-info.bits_per_sample // 8))
        ).digest()
        md5_ok = info.md5 == bytes(16) or md5 == info.md5
    write_wav(
        args.output, decoded, info.channels, info.bits_per_sample, info.sample_rate
    )
    display.progress_decoded(
        args.source, args.output, len(decoded) // max(info.channels, 1), md5_ok
    )
    # MD5 mismatch exits EX_CANTCREAT like the reference (main.rs:352-356)
    return 0 if md5_ok else EX_CANTCREAT


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    # default subcommand is `encode` (main.rs:404-418)
    if argv and argv[0] not in ("encode", "encode-corpus", "decode", "-h", "--help"):
        argv.insert(0, "encode")
    args = _build_parser().parse_args(argv)
    display.banner()
    if args.command is None:
        _build_parser().print_help()
        return EX_USAGE
    try:
        if args.command == "encode":
            return main_enc(args)
        if args.command == "encode-corpus":
            return main_corpus(args)
        return main_dec(args)
    except FileNotFoundError as e:
        # the reference maps INPUT-open failures to EX_NOINPUT
        # (flacenc-bin/src/main.rs:226,281-293) and output-create
        # failures to EX_CANTCREAT (main.rs:251,309)
        display.error(str(e))
        inputs = set(getattr(args, "sources", None) or [])
        if getattr(args, "source", None):
            inputs.add(args.source)
        if getattr(args, "config", None):
            inputs.add(args.config)
        return EX_NOINPUT if e.filename in inputs else EX_CANTCREAT
    except OSError as e:
        display.error(str(e))
        return EX_IOERR
    except FlacencError as e:
        display.error(str(e))
        return EX_DATAERR
    except Exception as e:  # internal errors: EX_SOFTWARE (main.rs:234)
        display.error(f"internal error: {type(e).__name__}: {e}")
        return EX_SOFTWARE


if __name__ == "__main__":
    sys.exit(main())

"""CLI end-to-end tests (flacenc-bin analogues).

- default-subcommand insertion: `flacenc in.wav -o out.flac` behaves like
  `flacenc encode ...` (flacenc-bin/src/main.rs:404-418, arg_parser test
  main.rs:449-…)
- encode -> decode -> sample-exact WAV compare across channel counts and
  bit depths, incl. odd sample rates (integration_encoder_decoder,
  flacenc-bin/src/main.rs:571-696)
- TOML config load + dump (main.rs:207-247)
"""

import os

import numpy as np
import pytest

from flacenc_tpu import sigen
from flacenc_tpu.cli import main
from flacenc_tpu.source import FrameBuf
from flacenc_tpu.wav import WavFileSource, write_wav


def _make_wav(path, channels, bps, rate, n, seed=0):
    x = np.zeros(channels * n, np.int32)
    for ch in range(channels):
        x[ch::channels] = (
            sigen.Sine(100 + 7 * ch + seed, 0.4)
            .noise_with_seed(seed * 10 + ch, 0.02)
            .to_vec_quantized(bps, n)
        )
    write_wav(str(path), x, channels, bps, rate)
    return x


def _read_wav(path, channels, n):
    src = WavFileSource(str(path))
    fb = FrameBuf(channels, n)
    got = src.read_samples(n, fb)
    assert got == n
    return np.ascontiguousarray(fb.samples.T).reshape(-1)


def test_default_subcommand_inserted(tmp_path):
    # main.rs:404-418: bare `flacenc in.wav -o out.flac` means `encode`
    _make_wav(tmp_path / "in.wav", 2, 16, 44100, 3000)
    rc = main([str(tmp_path / "in.wav"), "-o", str(tmp_path / "out.flac")])
    assert rc == 0
    assert (tmp_path / "out.flac").read_bytes()[:4] == b"fLaC"


@pytest.mark.parametrize(
    "channels,bps,rate",
    [(1, 16, 44100), (2, 16, 16001), (3, 24, 95800), (2, 8, 8000)],
)
def test_cli_encode_decode_roundtrip(tmp_path, channels, bps, rate):
    # flacenc-bin/src/main.rs:571-696 matrix (reduced grid)
    n = 2000
    x = _make_wav(tmp_path / "in.wav", channels, bps, rate, n, seed=channels)
    rc = main([
        "encode", str(tmp_path / "in.wav"), "-o", str(tmp_path / "out.flac"),
    ])
    assert rc == 0
    rc = main([
        "decode", str(tmp_path / "out.flac"), "-o", str(tmp_path / "back.wav"),
    ])
    assert rc == 0
    back = _read_wav(tmp_path / "back.wav", channels, n)
    assert np.array_equal(back, x)


def test_cli_config_load_and_dump(tmp_path):
    # main.rs:207-247
    cfg_path = tmp_path / "cfg.toml"
    cfg_path.write_text("block_size = 1024\n[subframe_coding.qlpc]\nlpc_order = 6\n")
    _make_wav(tmp_path / "in.wav", 2, 16, 44100, 2100)
    dump = tmp_path / "dump.toml"
    rc = main([
        "encode", str(tmp_path / "in.wav"), "-o", str(tmp_path / "out.flac"),
        "--config", str(cfg_path), "--dump-config", str(dump),
    ])
    assert rc == 0
    from flacenc_tpu import config

    dumped = config.Encoder.from_toml(dump.read_text())
    assert dumped.block_size == 1024
    assert dumped.subframe_coding.qlpc.lpc_order == 6


def test_cli_missing_input_exits_noinput(tmp_path):
    rc = main(["encode", str(tmp_path / "nope.wav"), "-o", str(tmp_path / "o.flac")])
    assert rc == 66  # EX_NOINPUT


def test_cli_missing_output_dir_exits_cantcreat(tmp_path):
    """Output-create failures are EX_CANTCREAT (73) like the reference
    (main.rs:251,309); only input-open failures map to EX_NOINPUT 66."""
    _make_wav(tmp_path / "in.wav", 2, 16, 44100, 2000)
    rc = main([
        "encode", str(tmp_path / "in.wav"),
        "-o", str(tmp_path / "no_such_dir" / "out.flac"),
    ])
    assert rc == 73


def test_cli_strict_float_and_profile_trace(tmp_path):
    """New flags: encode --strict-float == encode-corpus --strict-float
    byte-for-byte; --profile-trace writes a jax trace directory."""
    _make_wav(tmp_path / "in.wav", 2, 16, 44100, 2500)
    assert main([
        "encode", str(tmp_path / "in.wav"), "-o", str(tmp_path / "s.flac"),
        "--strict-float",
    ]) == 0
    assert main([
        "encode-corpus", str(tmp_path / "in.wav"),
        "--output-dir", str(tmp_path / "out"), "--strict-float",
    ]) == 0
    assert (tmp_path / "s.flac").read_bytes() == \
        (tmp_path / "out" / "in.flac").read_bytes()

    trace = tmp_path / "trace"
    assert main([
        "encode", str(tmp_path / "in.wav"), "-o", str(tmp_path / "p.flac"),
        "--profile-trace", str(trace),
    ]) == 0
    assert trace.is_dir()


def test_stream_encoder_with_wav_file_source(tmp_path):
    """WavFileSource straight into the batched stream encoder: exercises
    AsyncContext.fill_le_bytes (raw-byte MD5 surface, source.rs:80-111)
    and checks the digest against the synchronous reference path."""
    from flacenc_tpu import config
    from flacenc_tpu.models import batch_encoder as be
    from flacenc_tpu.models import reference_encoder as re_

    n = 1024 * 2 + 300
    x = _make_wav(tmp_path / "in.wav", 2, 16, 44100, n, seed=3)
    cfg = config.Encoder().into_verified()
    d = be.encode_with_fixed_block_size(
        cfg, WavFileSource(str(tmp_path / "in.wav")), 1024, batch_size=2
    )
    r = re_.encode_with_fixed_block_size(
        cfg, WavFileSource(str(tmp_path / "in.wav")), 1024
    )
    assert d.stream_info().md5 == r.stream_info().md5
    assert d.to_bytes() == r.to_bytes()
    from flacenc_tpu.component import decode_stream, parse_stream

    assert np.array_equal(decode_stream(parse_stream(d.to_bytes())), x)


def test_wav_non_multiple_of_8_bits(tmp_path):
    """12-/20-bit WAVs store samples in ceil(bits/8) container bytes
    (right-aligned, sign-extended — hound's convention in the reference
    CLI); bytes_per_sample = bits//8 would regroup them as garbage."""
    from flacenc_tpu.wav import read_wav, write_wav

    for bits, amp in ((12, 2000), (20, 400000)):
        n = 301
        x = ((np.arange(2 * n) * 37) % (2 * amp) - amp).astype(np.int32)
        p = tmp_path / f"b{bits}.wav"
        write_wav(str(p), x, 2, bits, 44100)
        y, ch, b2, rate = read_wav(str(p))
        assert (ch, b2, rate) == (2, bits, 44100)
        assert np.array_equal(y, x)
        src = WavFileSource(str(p))
        fb = FrameBuf(2, n)
        assert src.read_samples(n, fb) == n
        assert np.array_equal(
            np.ascontiguousarray(fb.samples.T).reshape(-1), x
        )

    # odd-length 8-bit data chunk gets a RIFF pad byte
    from flacenc_tpu.wav import write_wav as ww

    p = tmp_path / "odd8.wav"
    ww(str(p), np.arange(-1, 2, dtype=np.int32), 1, 8, 8000)
    raw = p.read_bytes()
    assert len(raw) % 2 == 0  # word-aligned file
    y, ch, b2, rate = read_wav(str(p))
    assert np.array_equal(y, np.arange(-1, 2, dtype=np.int32))


def test_cli_encode_streams_bounded_memory(tmp_path):
    """`encode` streams blocks from disk (flacenc-bin/src/source.rs:54-133
    behavior): peak Python-heap growth while encoding a ~24 MB WAV stays
    far below the input size (pipeline window + output frames only), i.e.
    the CLI no longer slurps the file into a MemSource."""
    import tracemalloc

    rate, n = 44100, 6_000_000
    t = np.arange(n, dtype=np.float64)
    x = np.empty(2 * n, np.int32)
    x[0::2] = np.round(12000 * np.sin(2 * np.pi * 220.0 / rate * t)).astype(np.int32)
    x[1::2] = np.round(11000 * np.sin(2 * np.pi * 330.0 / rate * t)).astype(np.int32)
    write_wav(str(tmp_path / "big.wav"), x, 2, 16, rate)
    del x, t

    # warmup encode spanning at least DEFAULT_BATCH full blocks: the
    # device program for the DEFAULT batch size must compile outside the
    # measured region (a shorter file hits the short-stream batch-size
    # clamp and warms a SMALLER program, leaving ~15 MB of jit tracing
    # for the big file's program inside the traced window)
    from flacenc_tpu.models.batch_encoder import DEFAULT_BATCH

    _make_wav(tmp_path / "warm.wav", 2, 16, rate, DEFAULT_BATCH * 4096 + 1000)
    assert main([
        "encode", str(tmp_path / "warm.wav"),
        "-o", str(tmp_path / "warm.flac"),
    ]) == 0

    tracemalloc.start()
    try:
        tracemalloc.reset_peak()
        rc = main([
            "encode", str(tmp_path / "big.wav"),
            "-o", str(tmp_path / "big.flac"),
        ])
        _, peak = tracemalloc.get_traced_memory()
    finally:
        tracemalloc.stop()
    assert rc == 0
    in_bytes = os.path.getsize(tmp_path / "big.wav")
    # depth x batch window + assembled frames (measured ~19-25 MB at
    # depth 4, ~25-33 MB at the default depth 8; jitters with pipeline
    # timing); a MemSource slurp holds input + int32 deinterleave +
    # window + output, i.e. >= 2x the input on the Python heap — 1.6x
    # input still separates the two regimes cleanly
    assert peak < in_bytes * 1.6, (peak, in_bytes)


@pytest.mark.parametrize("bps", [8, 16, 24])
def test_wav_bulk_read_matches_per_block(tmp_path, bps):
    """WavFileSource.read_blocks_batch (one disk read + raw-byte md5 per
    batch) must match the per-block read path byte- and digest-for-digest
    across container widths (8-bit offset PCM, 2-byte, 3-byte)."""
    from flacenc_tpu import config
    from flacenc_tpu.models import batch_encoder as be

    n = 1024 * 5 + 333  # partial batch + ragged tail
    x = _make_wav(tmp_path / "in.wav", 2, bps, 44100, n, seed=3)
    cfg = config.Encoder().into_verified()

    class NoBulk(WavFileSource):
        def read_blocks_batch(self, n_blocks, block_size, context):
            return None

    fast = be.encode_with_fixed_block_size(
        cfg, WavFileSource(str(tmp_path / "in.wav")), 1024, batch_size=4
    )
    slow = be.encode_with_fixed_block_size(
        cfg, NoBulk(str(tmp_path / "in.wav")), 1024, batch_size=4
    )
    assert fast.to_bytes() == slow.to_bytes()
    from flacenc_tpu.component import decode_stream, parse_stream

    assert np.array_equal(decode_stream(parse_stream(fast.to_bytes())), x)


def test_wav_bulk_read_after_seek(tmp_path):
    """Seek + bulk read compose: read_blocks_batch continues from the
    seek position and the remaining stream still encodes losslessly."""
    from flacenc_tpu.source import Context

    n = 1024 * 3
    x = _make_wav(tmp_path / "in.wav", 2, 16, 44100, n, seed=5)
    src = WavFileSource(str(tmp_path / "in.wav"))
    src.seek_samples(1024)
    ctx = Context(16, 2)
    chunk = src.read_blocks_batch(8, 1024, ctx)
    assert chunk.shape == (2, 2, 1024)
    want = x.reshape(-1, 2).T[:, 1024:]
    assert np.array_equal(chunk.transpose(1, 0, 2).reshape(2, -1), want)
    assert ctx.total_samples() == 2048


def test_wav_truncated_data_chunk_bulk_equals_per_block(tmp_path):
    """A WAV whose header claims more data than the file holds: the bulk
    path must re-seek past its truncated read so the per-block fallback
    still encodes the partial tail (round-3 advisor medium finding)."""
    from flacenc_tpu import config
    from flacenc_tpu.models import batch_encoder as be

    n = 1024 * 2 + 300  # 2 full blocks + a partial tail block
    _make_wav(tmp_path / "in.wav", 2, 16, 44100, n, seed=9)
    raw = (tmp_path / "in.wav").read_bytes()
    # chop 100 samples' bytes off the end WITHOUT fixing the data header
    (tmp_path / "trunc.wav").write_bytes(raw[: len(raw) - 100 * 2 * 2])

    cfg = config.Encoder().into_verified()

    class NoBulk(WavFileSource):
        def read_blocks_batch(self, n_blocks, block_size, context):
            return None

    fast = be.encode_with_fixed_block_size(
        cfg, WavFileSource(str(tmp_path / "trunc.wav")), 1024, batch_size=2
    )
    slow = be.encode_with_fixed_block_size(
        cfg, NoBulk(str(tmp_path / "trunc.wav")), 1024, batch_size=2
    )
    assert fast.to_bytes() == slow.to_bytes()
    # the tail present on disk (including the sub-block partial bytes)
    # must be encoded, not silently dropped (STREAMINFO total_samples
    # keeps the header's len_hint claim, like the reference
    # coding.rs:693 — the DECODED length is what proves the fix)
    from flacenc_tpu.component import decode_stream, parse_stream

    decoded = decode_stream(parse_stream(fast.to_bytes()))
    assert len(decoded) // 2 == n - 100


def test_wav_seek_past_end_raises(tmp_path):
    _make_wav(tmp_path / "in.wav", 2, 16, 44100, 500)
    src = WavFileSource(str(tmp_path / "in.wav"))
    with pytest.raises(ValueError, match="past the end"):
        src.seek_samples(501)


def test_wav_bulk_read_frame_count_in_blocks(tmp_path):
    """Bulk fills must advance Context.frame_count by the BLOCK count,
    not once per batch (round-3 advisor finding)."""
    from flacenc_tpu.source import Context

    n = 1024 * 3
    _make_wav(tmp_path / "in.wav", 2, 16, 44100, n, seed=3)
    src = WavFileSource(str(tmp_path / "in.wav"))
    ctx = Context(16, 2)
    src.read_blocks_batch(8, 1024, ctx)
    assert ctx.frame_count == 3
    assert ctx.current_frame_number() == 2


def test_cli_encodes_in_process_without_probe_or_reexec(monkeypatch, tmp_path):
    """The CLI runs the encode in its own process on the backend JAX
    chose: no liveness probe, no re-exec onto another backend."""
    import importlib.util

    def no_exec(*a, **k):
        raise AssertionError("the CLI must not exec another process")

    monkeypatch.setattr("os.execve", no_exec)
    monkeypatch.setattr("os.execv", no_exec)
    n = 4096 + 300
    x = _make_wav(tmp_path / "in.wav", 2, 16, 44100, n, seed=4)
    assert main(["encode", str(tmp_path / "in.wav"),
                 "-o", str(tmp_path / "out.flac")]) == 0
    assert main(["decode", str(tmp_path / "out.flac"),
                 "-o", str(tmp_path / "back.wav")]) == 0
    assert np.array_equal(_read_wav(tmp_path / "back.wav", 2, n), x)
    assert importlib.util.find_spec("flacenc_tpu.utils.probe") is None


@pytest.mark.parametrize("cpu_only", [True, False])
def test_cpu_only_is_the_only_platform_pin(monkeypatch, cpu_only):
    """--cpu-only pins jax to the CPU backend; without it the CLI leaves
    the platform to JAX."""
    import jax

    import flacenc_tpu.cli as cli

    updates = []
    monkeypatch.setattr(jax.config, "update",
                        lambda k, v: updates.append((k, v)))

    class Args:
        pass

    args = Args()
    args.cpu_only = cpu_only
    cli._pin_cpu_if_asked(args)
    assert updates == ([("jax_platforms", "cpu")] if cpu_only else [])

"""Device-pipeline parity tests: the batched JAX encoder must reproduce the
scalar numpy oracle's output byte-for-byte (the device<->scalar analogue of
the reference's SIMD<->scalar parity tests, SURVEY.md §4).

Small shapes keep jit compilation cheap; the full-size path is exercised by
bench.py on real hardware.
"""

import numpy as np
import pytest

from flacenc_tpu import config, sigen, source
from flacenc_tpu.component import decode_stream, parse_stream
from flacenc_tpu.models import batch_encoder as be
from flacenc_tpu.models import reference_encoder as re

T = 1024  # small block keeps the jit fast in CI


def stereo_signal(n, noise=0.01, bps=16):
    x = np.zeros(2 * n, dtype=np.int32)
    x[0::2] = sigen.Sine(128, 0.4).noise_with_seed(1, noise).to_vec_quantized(bps, n)
    x[1::2] = sigen.Sine(130, 0.4).noise_with_seed(2, noise).to_vec_quantized(bps, n)
    return x


def encode_both(interleaved, channels, bps, rate, block_size):
    cfg = config.Encoder().into_verified()
    s_dev = be.encode_with_fixed_block_size(
        cfg, source.MemSource(interleaved, channels, bps, rate), block_size
    )
    s_ref = re.encode_with_fixed_block_size(
        cfg, source.MemSource(interleaved, channels, bps, rate), block_size
    )
    return s_dev.to_bytes(), s_ref.to_bytes()


def test_device_matches_oracle_stereo():
    interleaved = stereo_signal(T * 3 + 333)
    d, r = encode_both(interleaved, 2, 16, 44100, T)
    assert d == r, "device and oracle encoders must produce identical streams"
    dec = decode_stream(parse_stream(d))
    assert np.array_equal(dec, interleaved)


def test_device_matches_oracle_mono():
    n = T * 2
    x = sigen.Sine(100, 0.5).noise_with_seed(5, 0.02).to_vec_quantized(16, n)
    d, r = encode_both(x, 1, 16, 44100, T)
    assert d == r
    dec = decode_stream(parse_stream(d))
    assert np.array_equal(dec, x)


def test_device_constant_and_verbatim_blocks():
    # first block constant, second block high-entropy (verbatim-ish)
    n = T * 2
    x = np.zeros(2 * n, np.int32)
    x[0 : 2 * T : 2] = 777
    x[1 : 2 * T : 2] = -3
    noisy = sigen.Noise(0.999, seed0=3).to_vec_quantized(16, T)
    x[2 * T :: 2] = noisy
    x[2 * T + 1 :: 2] = noisy[::-1].copy()
    d, r = encode_both(x, 2, 16, 44100, T)
    assert d == r
    dec = decode_stream(parse_stream(d))
    assert np.array_equal(dec, x)


def test_device_stereo_modes_match():
    # strongly correlated channels exercise the M/S selection path
    n = T * 2
    base = sigen.Sine(150, 0.5).noise_with_seed(3, 0.02).to_vec_quantized(16, n)
    detune = sigen.Noise(0.001, seed0=8).to_vec_quantized(16, n)
    x = np.zeros(2 * n, np.int32)
    x[0::2] = base
    x[1::2] = np.clip(
        base.astype(np.int64) + detune, -(1 << 15), (1 << 15) - 1
    ).astype(np.int32)
    d, r = encode_both(x, 2, 16, 44100, T)
    assert d == r
    dec = decode_stream(parse_stream(d))
    assert np.array_equal(dec, x)


def test_device_24bit():
    n = T + 100
    x = stereo_signal(n, noise=0.005, bps=24)
    d, r = encode_both(x, 2, 24, 96000, T)
    assert d == r
    dec = decode_stream(parse_stream(d))
    assert np.array_equal(dec, x)


@pytest.mark.parametrize("channels", [3, 5])
def test_device_multichannel_independent(channels):
    """>2 channels: no stereo search, independent assignment per channel
    (coding.rs:421-449); device must still match the oracle byte-for-byte."""
    n = T + 57
    x = np.zeros(channels * n, np.int32)
    for ch in range(channels):
        x[ch::channels] = (
            sigen.Sine(90 + 17 * ch, 0.4)
            .noise_with_seed(ch + 1, 0.01)
            .to_vec_quantized(16, n)
        )
    d, r = encode_both(x, channels, 16, 32000, T)
    assert d == r
    dec = decode_stream(parse_stream(d))
    assert np.array_equal(dec, x)


def test_bulk_read_path_matches_per_block():
    """`Source.read_blocks_batch` (one md5 fill + one deinterleave per
    batch) must be byte- and digest-identical to the per-block loop: a
    source WITHOUT the bulk override forces the fallback path."""
    import hashlib

    from flacenc_tpu.source import MemSource, samples_to_le_bytes

    class NoBulk(MemSource):
        def read_blocks_batch(self, n_blocks, block_size, context):
            return None

    rng = np.random.default_rng(11)
    cfg = config.Encoder().into_verified()
    # odd length -> partial batch + ragged oracle tail; mono + stereo
    for n, ch, bs in ((1024 * 9 + 777, 2, 1024), (4096 * 3, 1, 4096),
                      (500, 2, 256)):
        x = rng.integers(-20000, 20000, n * ch, dtype=np.int64).astype(
            np.int32
        )
        fast = be.encode_with_fixed_block_size(
            cfg, MemSource(x, ch, 16, 44100), bs, batch_size=4
        )
        slow = be.encode_with_fixed_block_size(
            cfg, NoBulk(x, ch, 16, 44100), bs, batch_size=4
        )
        assert fast.to_bytes() == slow.to_bytes(), (n, ch, bs)
        assert fast.stream_info().md5 == hashlib.md5(
            samples_to_le_bytes(x, 2)
        ).digest(), (n, ch, bs)
        assert np.array_equal(
            decode_stream(parse_stream(fast.to_bytes())), x
        ), (n, ch, bs)

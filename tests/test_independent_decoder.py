"""Clean-room C++ decoder oracle (native/decoder.cpp + native/independent.py).

The decoder is written against RFC 9639 only and shares zero code with
component/ or packer.cpp — the role claxon plays in the reference's
integrity tests (/root/reference/src/test_helper.rs:131-185). These tests
check it agrees sample-exactly with the encoder across the feature
matrix, and that it REJECTS corrupted streams (a decoder that cannot
fail cannot verify)."""

import hashlib

import numpy as np
import pytest

from flacenc_tpu import config, sigen, source
from flacenc_tpu.models import batch_encoder as be
from flacenc_tpu.models import reference_encoder as re
from flacenc_tpu.native import independent

pytestmark = pytest.mark.skipif(
    not independent.available(), reason="independent decoder unavailable"
)


def _signal(channels, n, bps, seed=0):
    x = np.zeros(n * channels, np.int32)
    for ch in range(channels):
        x[ch::channels] = (
            sigen.Sine(120 + 9 * ch + seed, 0.5)
            .noise_with_seed(seed * 13 + ch, 0.04)
            .to_vec_quantized(bps, n)
        )
    return x


def _encode(x, channels, bps, rate, block, cfg=None, device=True):
    cfg = (cfg or config.Encoder()).into_verified()
    src = source.MemSource(x, channels, bps, rate)
    if device:
        s = be.encode_with_fixed_block_size(cfg, src, block, batch_size=4)
    else:
        s = re.encode_with_fixed_block_size(cfg, src, block)
    return s.to_bytes()


@pytest.mark.parametrize("channels,bps", [(1, 8), (2, 16), (2, 24), (5, 16), (8, 12)])
def test_roundtrip_matrix(channels, bps):
    n = 1024 * 3 + 311  # ragged tail
    x = _signal(channels, n, bps, seed=channels)
    data = _encode(x, channels, bps, 44100, 1024)
    dec = independent.decode_stream(data)
    assert np.array_equal(dec.samples, x)
    assert (dec.channels, dec.bits_per_sample, dec.sample_rate) == (
        channels, bps, 44100,
    )
    assert dec.total_samples == n
    assert dec.n_frames == -(-n // 1024)
    md5 = hashlib.md5(
        source.samples_to_le_bytes(x, -(-bps // 8))
    ).digest()
    assert dec.md5 == md5


def test_stereo_modes_and_configs():
    """L/R vs L/S vs R/S vs M/S de-rotation: correlated stereo drives the
    encoder through the side-channel assignments; restricted configs
    force specific ones."""
    n = 2048 * 2
    base = sigen.Sine(200, 0.6).noise_with_seed(3, 0.03).to_vec_quantized(16, n)
    other = (base // 2 + sigen.Noise(0.01, seed0=9).to_vec_quantized(16, n)).astype(
        np.int32
    )
    x = np.zeros(2 * n, np.int32)
    x[0::2], x[1::2] = base, np.clip(other, -32768, 32767)
    for toggles in (
        {},  # all four candidates
        {"use_midside": False},
        {"use_leftside": False, "use_midside": False},
        {"use_leftside": False, "use_rightside": False, "use_midside": False},
    ):
        cfg = config.Encoder()
        for k, v in toggles.items():
            setattr(cfg.stereo_coding, k, v)
        data = _encode(x, 2, 16, 48000, 2048, cfg=cfg)
        dec = independent.decode_stream(data)
        assert np.array_equal(dec.samples, x), toggles


def test_all_subframe_types():
    """Constant + verbatim + fixed + LPC frames in one stream."""
    n = 1024 * 4
    x = np.zeros(2 * n, np.int32)
    x[0 : 2 * 1024 : 2] = 777            # constant block
    rng = np.random.default_rng(4)
    x[2 * 1024 : 4 * 1024 : 2] = rng.integers(-32768, 32768, 1024)  # verbatim-ish
    x[4 * 1024 :: 2] = sigen.Sine(150, 0.7).to_vec_quantized(16, n - 2 * 1024)
    x[1::2] = sigen.Sine(99, 0.2).noise_with_seed(8, 0.3).to_vec_quantized(16, n)
    data = _encode(x, 2, 16, 44100, 1024)
    dec = independent.decode_stream(data)
    assert np.array_equal(dec.samples, x)


def test_oracle_and_batch_paths_agree():
    n = 4096 + 701
    x = _signal(2, n, 16, seed=5)
    d_dev = _encode(x, 2, 16, 44100, 4096, device=True)
    d_ref = _encode(x, 2, 16, 44100, 4096, device=False)
    for data in (d_dev, d_ref):
        assert np.array_equal(independent.decode_stream(data).samples, x)


def test_corruption_rejected():
    """Every corruption class must raise: the oracle's value is that it
    FAILS on bad streams (claxon-style)."""
    n = 4096 * 2
    x = _signal(2, n, 16, seed=7)
    data = bytearray(_encode(x, 2, 16, 44100, 4096))

    with pytest.raises(independent.IndependentDecodeError, match="magic"):
        independent.decode_stream(b"fLaX" + bytes(data[4:]))
    with pytest.raises(independent.IndependentDecodeError, match="truncated"):
        independent.decode_stream(bytes(data[: len(data) // 2 - 3]))

    # flip one bit in a frame body -> CRC-16 (or earlier check) trips
    bad = data.copy()
    bad[len(bad) - 40] ^= 0x04
    with pytest.raises(independent.IndependentDecodeError):
        independent.decode_stream(bytes(bad))

    # corrupt the first frame header byte after sync -> CRC-8 or header
    hdr = 4 + 4 + 34  # magic + metadata header + STREAMINFO
    assert data[hdr] == 0xFF and (data[hdr + 1] & 0xF8) == 0xF8
    bad = data.copy()
    bad[hdr + 2] ^= 0x10
    with pytest.raises(independent.IndependentDecodeError):
        independent.decode_stream(bytes(bad))

    # corrupt the STREAMINFO md5 field: decode succeeds (samples are
    # intact) but the reported md5 must then mismatch the recomputed one
    bad = data.copy()
    bad[hdr - 10] ^= 0xFF
    dec = independent.decode_stream(bytes(bad))
    md5 = hashlib.md5(source.samples_to_le_bytes(dec.samples, 2)).digest()
    assert dec.md5 != md5
    assert np.array_equal(dec.samples, x)


def test_embedded_reference_signals():
    """The reference's embedded real-audio test signals decode exactly
    through the clean-room oracle (test_helper.rs integrity matrix)."""
    import os

    resource_dir = "/root/reference/src/resource"
    if not os.path.isdir(resource_dir):
        pytest.skip("reference resources not mounted")

    def load_signal(name, ch):
        path = os.path.join(resource_dir, f"testsignal.{name}.ch{ch}.bin")
        with open(path, "rb") as f:
            return np.frombuffer(f.read(), dtype="<i2").astype(np.int32)

    for name in ("sus109", "ras22"):
        left = load_signal(name, 0)
        right = load_signal(name, 1)
        n = min(len(left), len(right), 4096 * 3)
        x = np.zeros(2 * n, np.int32)
        x[0::2], x[1::2] = left[:n], right[:n]
        data = _encode(x, 2, 16, 44100, 4096)
        dec = independent.decode_stream(data)
        assert np.array_equal(dec.samples, x), name

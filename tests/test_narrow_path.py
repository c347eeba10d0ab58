"""int16-storage fast path (bps <= 16): byte-identical, range-safe.

The bulk read paths keep 16-bit PCM as int16 end-to-end (storage,
deinterleave, wire scans, device upload, C++ recompute packer) — half
the single-core memory traffic of the old widen-to-int32 pipeline.
These tests pin the contract: bytes NEVER depend on the storage dtype,
and the reference's sample-range check (source.rs:262-277) still fires
for out-of-range samples.
"""

import numpy as np
import pytest

from flacenc_tpu import config, native
from flacenc_tpu.models import batch_encoder as be
from flacenc_tpu.source import MemSource, deinterleave_blocks

import flacenc_tpu


def _stereo(n, seed=0, amp=9000, noise=None):
    rng = np.random.default_rng(seed)
    t = np.arange(n)
    s = (amp * np.sin(t * 0.03)).astype(np.int32)
    x = np.empty(2 * n, np.int32)
    x[0::2] = s
    x[1::2] = rng.integers(-amp, amp, n) if noise else np.roll(s, 5)
    return x


def test_memsource_narrows_to_int16_when_in_range():
    x = _stereo(4096)
    assert MemSource(x, 2, 16, 44100)._samples.dtype == np.int16
    # 24-bit input stays int32
    assert MemSource(x, 2, 24, 96000)._samples.dtype == np.int32


def test_memsource_keeps_int32_for_out_of_range_samples():
    x = _stereo(4096)
    x[100] = 40000  # does not fit int16
    src = MemSource(x, 2, 16, 44100)
    assert src._samples.dtype == np.int32
    # and the range check still fires during encode (no silent wrap)
    with pytest.raises(Exception, match="range|16-bit"):
        be.encode_with_fixed_block_size(
            config.Encoder().into_verified(), src, 4096, batch_size=4
        )


def test_range_check_fires_for_narrow_storage_below_16bit():
    x = np.clip(_stereo(4096 * 2), -2048, 2047)
    x[777] = 2500  # fits int16, violates bps=12
    src = MemSource(x, 2, 12, 44100)
    assert src._samples.dtype == np.int16
    with pytest.raises(Exception, match="range|12-bit"):
        be.encode_with_fixed_block_size(
            config.Encoder().into_verified(), src, 4096, batch_size=4
        )


def test_deinterleave_preserves_dtype():
    flat = np.arange(2 * 3 * 64, dtype=np.int16)
    out = deinterleave_blocks(flat, 3, 64, 2)
    assert out.dtype == np.int16 and out.shape == (3, 2, 64)
    np.testing.assert_array_equal(
        out, deinterleave_blocks(flat.astype(np.int32), 3, 64, 2)
    )


def test_bulk_int16_stream_matches_scalar_oracle_bytes():
    # tonal material with a ragged tail block; includes MD5 in STREAMINFO
    x = _stereo(4096 * 5 + 1234, seed=3)
    cfg = config.Encoder().into_verified()
    a = be.encode_with_fixed_block_size(
        cfg, MemSource(x, 2, 16, 44100), 4096, batch_size=4
    ).to_bytes()
    b = flacenc_tpu.encode_with_fixed_block_size(
        cfg, MemSource(x, 2, 16, 44100), 4096, use_device=False
    ).to_bytes()
    assert a == b


def test_int16_and_int32_device_paths_byte_identical_on_noise():
    # full-scale noise exercises verbatim subframes, high rice params,
    # and the int16-overflow-adjacent paths
    x = _stereo(4096 * 6, seed=11, amp=32700, noise=True)
    cfg = config.Encoder().into_verified()
    src16 = MemSource(x, 2, 16, 44100)
    assert src16._samples.dtype == np.int16
    src32 = MemSource(x, 2, 16, 44100)
    src32._samples = x.astype(np.int32)  # defeat narrowing
    a = be.encode_with_fixed_block_size(cfg, src16, 4096,
                                        batch_size=4).to_bytes()
    b = be.encode_with_fixed_block_size(cfg, src32, 4096,
                                        batch_size=4).to_bytes()
    assert a == b


@pytest.mark.parametrize("mode", ["on", "delta"])
def test_int16_upload_wires_byte_identical(mode):
    x = _stereo(4096 * 4, seed=5)
    cfg = config.Encoder().into_verified()
    ref = be.encode_with_fixed_block_size(
        cfg, MemSource(x, 2, 16, 44100), 4096, batch_size=4
    ).to_bytes()
    got = be.encode_with_fixed_block_size(
        cfg, MemSource(x, 2, 16, 44100), 4096, batch_size=4,
        upload_pack=mode,
    ).to_bytes()
    assert got == ref


@pytest.mark.skipif(not native.available(), reason="native lib unavailable")
def test_native_wire_passes_int16_int32_parity():
    rng = np.random.default_rng(7)
    c32 = rng.integers(-32768, 32768, (6, 2, 4096)).astype(np.int32)
    # int16 extremes: wrap-prone deltas (+/-65535 at order 1)
    c32[0, 0, :8] = [-32768, 32767, -32768, 32767, 0, 1, -1, -32768]
    c16 = c32.astype(np.int16)
    s32, mm32 = native.scan_wire(c32)
    s16, mm16 = native.scan_wire(c16)
    np.testing.assert_array_equal(s32, s16)
    np.testing.assert_array_equal(mm32, mm16)
    r32 = native.pack_rice(c32, 2, 16, 3000)
    r16 = native.pack_rice(c16, 2, 16, 3000)
    assert r32 is not None and r16 is not None
    for a, b in zip(r32, r16):
        np.testing.assert_array_equal(a, b)
    for order, width in ((1, 18), (2, 20), (1, 8)):
        w32 = native.pack_upload(c32, order, width)
        w16 = native.pack_upload(c16, order, width)
        for a, b in zip(w32, w16):
            np.testing.assert_array_equal(a, b)


def test_wav_bulk_int16_matches_per_block_bytes(tmp_path):
    from flacenc_tpu import wav

    x = _stereo(4096 * 3 + 777, seed=9)
    p = tmp_path / "t.wav"
    wav.write_wav(str(p), x, 2, 16, 44100)
    cfg = config.Encoder().into_verified()
    src = wav.WavFileSource(str(p))
    a = be.encode_with_fixed_block_size(cfg, src, 4096,
                                        batch_size=4).to_bytes()
    src.close()
    b = flacenc_tpu.encode_with_fixed_block_size(
        cfg, MemSource(x, 2, 16, 44100), 4096, use_device=False
    ).to_bytes()
    assert a == b

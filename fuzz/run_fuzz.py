"""Property-based fuzz harness (the cargo-fuzz target analogue).

Mirrors ``/root/reference/fuzz/fuzz_targets/frame_encode.rs``: random
channel counts (1-8), block sizes (32-32767), sample rates, bits-per-sample
(8-24), random encoder configs (stereo toggles, windows, orders, order
selectors), and compositional random signals; the property is
encode -> verify -> serialize -> CRC-checked parse -> decode == input.

Run standalone for an unbounded campaign:
    python fuzz/run_fuzz.py [--iters N] [--seed S] [--max-block 4096]
Failing cases print a reproducible seed and dump the component struct.
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

from flacenc_tpu import config, sigen, source
from flacenc_tpu.component import decode_stream, parse_stream
from flacenc_tpu.component.verify import verify_stream
from flacenc_tpu.models import reference_encoder as re


def random_signal_gen(rng: np.random.Generator) -> sigen.Signal:
    """Compositional random signal (fuzz_targets/frame_encode.rs:72-126)."""
    kind = rng.integers(0, 4)
    period = int(rng.integers(2, 3000))
    amp = float(rng.uniform(0.01, 0.99))
    if kind == 0:
        base = sigen.Dc(float(rng.uniform(-0.9, 0.9)))
    elif kind == 1:
        base = sigen.Sine(period, amp, float(rng.uniform(0, 6.28)))
    elif kind == 2:
        base = sigen.Square(period, amp)
    else:
        base = sigen.Noise(amp, seed0=int(rng.integers(0, 2**32)))
    # random decorators
    for _ in range(int(rng.integers(0, 3))):
        deco = rng.integers(0, 3)
        if deco == 0:
            base = base.noise_with_seed(int(rng.integers(0, 2**32)), float(rng.uniform(0, 0.3)))
        elif deco == 1:
            base = base.clip()
        else:
            base = base.concat(
                int(rng.integers(1, 1000)),
                sigen.Noise(float(rng.uniform(0, 0.5)), seed0=int(rng.integers(0, 2**32))),
            )
    return base


def random_config(rng: np.random.Generator) -> config.Encoder:
    """Random valid encoder config (frame_encode.rs:37-70)."""
    cfg = config.Encoder()
    st = cfg.stereo_coding
    st.use_leftside = bool(rng.integers(0, 2))
    st.use_rightside = bool(rng.integers(0, 2))
    st.use_midside = bool(rng.integers(0, 2))
    sub = cfg.subframe_coding
    sub.use_constant = bool(rng.integers(0, 2))
    sub.use_fixed = bool(rng.integers(0, 2))
    sub.use_lpc = bool(rng.integers(0, 2))
    sub.fixed.max_order = int(rng.integers(0, 5))
    if rng.integers(0, 2):
        sub.fixed.order_sel = config.OrderSel.bit_count()
    else:
        sub.fixed.order_sel = config.OrderSel.approx_ent(int(rng.integers(1, 65)))
    sub.qlpc.lpc_order = int(rng.integers(1, 25))
    sub.qlpc.quant_precision = int(rng.integers(4, 16))
    if rng.integers(0, 2):
        sub.qlpc.window = config.Window.rectangle()
    else:
        sub.qlpc.window = config.Window.tukey(float(rng.uniform(0.0, 1.0)))
    sub.prc.max_parameter = int(rng.integers(4, 31))
    return cfg


def one_case(seed: int, max_block: int = 4096, verbose: bool = False) -> None:
    rng = np.random.default_rng(seed)
    channels = int(rng.integers(1, 9))
    block_size = int(rng.integers(32, max_block + 1))
    signal_len = int(rng.integers(1, 3 * block_size + 2))
    bps = int(rng.integers(8, 25))
    rate = int(rng.integers(1, 655351))
    cfg = random_config(rng).into_verified()

    interleaved = np.zeros(signal_len * channels, dtype=np.int32)
    for ch in range(channels):
        gen = random_signal_gen(rng)
        interleaved[ch::channels] = gen.to_vec_quantized(bps, signal_len)

    src = source.MemSource(interleaved, channels, bps, rate)
    stream = re.encode_with_fixed_block_size(cfg, src, block_size)
    if bps % 4 in (0, 1) and rate <= 96_000:
        # the component Verify gate mirrors the reference's domain
        # (verify.rs: bps multiple of 4, rate <= 96k); the encoder itself
        # handles the wider space, which the round trip below still checks
        verify_stream(stream)
    data = stream.to_bytes()
    parsed = parse_stream(data)  # CRC-verified
    decoded = decode_stream(parsed)
    assert np.array_equal(decoded, interleaved), (
        f"round-trip mismatch (seed={seed}, ch={channels}, block={block_size}, "
        f"bps={bps}, rate={rate})"
    )
    # fourth oracle: clean-room C++ decoder (zero shared code with the
    # encoder or the Python component model — the claxon analogue)
    from flacenc_tpu.native import independent

    if independent.available():
        dec = independent.decode_stream(data)
        assert np.array_equal(dec.samples, interleaved), (
            f"clean-room decode mismatch (seed={seed}, ch={channels}, "
            f"block={block_size}, bps={bps}, rate={rate})"
        )
    if verbose:
        print(
            f"seed={seed}: ch={channels} block={block_size} len={signal_len} "
            f"bps={bps} rate={rate} -> {len(data)}B ok"
        )


DEVICE_CONFIGS = None


def _device_configs():
    """Canned configs for device fuzzing (each compiles one program)."""
    global DEVICE_CONFIGS
    if DEVICE_CONFIGS is None:
        cfgs = [config.Encoder()]
        c = config.Encoder(); c.subframe_coding.use_lpc = False; cfgs.append(c)
        c = config.Encoder(); c.subframe_coding.fixed.order_sel = config.OrderSel.bit_count(); cfgs.append(c)
        c = config.Encoder(); c.subframe_coding.qlpc.window = config.Window.rectangle(); c.subframe_coding.qlpc.lpc_order = 4; cfgs.append(c)
        c = config.Encoder(); c.stereo_coding.use_midside = False; c.subframe_coding.prc.max_parameter = 20; cfgs.append(c)
        DEVICE_CONFIGS = cfgs
    return DEVICE_CONFIGS


def one_device_case(seed: int, block_size: int = 512, strict: bool = False) -> bool:
    """Random signal, canned config: the device<->scalar fuzz tier.
    Returns True when the default-mode bytes differed from the oracle's
    (and the difference passed every check below).

    Strict tier: device stream must byte-equal the oracle stream (all
    integer device logic — rice search, bit counts, selection, FIR — is
    pinned exactly; float estimation is shared host-side).

    Default tier: streams are byte-equal except on measure-zero float
    rounding ties (XLA vs numpy f64/f32 accumulation order in LPC/entropy
    estimation — the documented default-mode deviation, DESIGN.md). When
    bytes differ, the case must (a) still verify + decode losslessly,
    (b) stay within a small size tolerance, and (c) become byte-equal
    under strict mode on the same input — proving the divergence is the
    estimation tie and nothing else. (First hit: seed 630, a quantized
    coefficient differing by 1 after a 1-ulp autocorr sum difference.)"""
    from flacenc_tpu.component.verify import verify_stream as _verify
    from flacenc_tpu.models import batch_encoder as be

    rng = np.random.default_rng(seed)
    if strict:
        cfg = config.Encoder().into_verified()  # one program for strict tier
    else:
        cfg = _device_configs()[seed % len(_device_configs())].into_verified()
    channels = 2 if rng.integers(0, 2) else 1
    signal_len = int(rng.integers(1, 5 * block_size))
    bps = 16
    interleaved = np.zeros(signal_len * channels, dtype=np.int32)
    for ch in range(channels):
        interleaved[ch::channels] = random_signal_gen(rng).to_vec_quantized(
            bps, signal_len
        )
    src = lambda: source.MemSource(interleaved, channels, bps, 44100)
    stream_d = be.encode_with_fixed_block_size(
        cfg, src(), block_size, batch_size=8, strict_lpc=strict,
    )
    d = stream_d.to_bytes()
    r = re.encode_with_fixed_block_size(
        cfg, src(), block_size, strict_lpc=strict,
    ).to_bytes()
    assert np.array_equal(decode_stream(parse_stream(d)), interleaved)
    if d == r:
        return False
    if strict:
        raise AssertionError(
            f"strict device/oracle stream mismatch (seed={seed})"
        )
    # default mode: divergence is only acceptable if it is exactly the
    # documented float-estimation tie
    _verify(stream_d)
    assert abs(len(d) - len(r)) <= max(64, len(r) // 16), (
        f"size divergence too large (seed={seed}): {len(d)} vs {len(r)}"
    )
    ds = be.encode_with_fixed_block_size(
        cfg, src(), block_size, batch_size=8, strict_lpc=True,
    ).to_bytes()
    rs = re.encode_with_fixed_block_size(
        cfg, src(), block_size, strict_lpc=True,
    ).to_bytes()
    assert ds == rs, (
        f"divergence NOT resolved by strict mode (seed={seed}) — "
        "this is a real device/oracle bug, not an estimation tie"
    )
    return True


_MUTATE_BASE = None


def one_mutation_case(seed: int) -> None:
    """Parser robustness on malformed input (parser.rs:183-236 discipline):
    mutate / truncate a valid stream; parsing must raise ParseError or
    succeed (then decode must not crash) — single-bit flips inside the
    frame region must always be caught (CRC-8/CRC-16 guarantee)."""
    from flacenc_tpu.component.parser import ParseError
    from flacenc_tpu.errors import FlacencError

    global _MUTATE_BASE
    if _MUTATE_BASE is None:
        rng0 = np.random.default_rng(0)
        interleaved = np.zeros(3000 * 2, dtype=np.int32)
        for ch in range(2):
            interleaved[ch::2] = random_signal_gen(rng0).to_vec_quantized(16, 3000)
        src = source.MemSource(interleaved, 2, 16, 44100)
        _MUTATE_BASE = re.encode_with_fixed_block_size(
            config.Encoder().into_verified(), src, 512
        ).to_bytes()
    data = _MUTATE_BASE
    frames_start = 4 + 4 + 34
    rng = np.random.default_rng(seed)
    mode = seed % 3
    buf = bytearray(data)
    if mode == 0:  # single-bit flip in the frame region: MUST be detected
        pos = int(rng.integers(frames_start, len(buf)))
        buf[pos] ^= 1 << int(rng.integers(0, 8))
        try:
            parse_stream(bytes(buf))
        except ParseError:
            return
        raise AssertionError(
            f"bit flip at byte {pos} not detected (seed={seed})"
        )
    if mode == 1:  # arbitrary byte garbage anywhere: must never crash
        for _ in range(int(rng.integers(1, 8))):
            buf[int(rng.integers(0, len(buf)))] = int(rng.integers(0, 256))
    else:  # truncation
        buf = buf[: int(rng.integers(0, len(buf)))]
    try:
        decode_stream(parse_stream(bytes(buf)))
    except FlacencError:
        pass


def one_upload_case(seed: int, block_size: int = 512) -> None:
    """Wire-format transparency tier: for any signal (smooth, loud, or
    mixed so batches land on DIFFERENT adaptive formats — order 1/2,
    width 8..12 — or fall back to raw mid-stream), upload_pack=True must
    emit EXACTLY the bytes of upload_pack=False — the wire format can
    never change output. Per-case amplitude scaling steers batches across
    the whole (order, width) matrix; the chosen formats are recorded and
    the harness asserts the matrix was actually covered across the run."""
    from flacenc_tpu.models import batch_encoder as be
    from flacenc_tpu.ops import upack

    rng = np.random.default_rng(seed)
    channels = 2 if rng.integers(0, 2) else 1
    signal_len = int(rng.integers(1, 6 * block_size))
    # ~1/4 of cases exercise hi-res PCM: the wide widths (14-20) and
    # high rice parameters only fire there (bps 17-24 otherwise uploads
    # raw int32); the delta16 wire stays bps <= 16 (mod-2^16 decode)
    bps = int(rng.choice([16, 16, 16, 20, 24]))
    # amplitude scaling sweeps the delta magnitude so the scan lands on
    # every width tier (and on raw for full-scale content)
    shift = int(rng.integers(0, 9))
    tonal = rng.integers(0, 3) == 0
    if tonal:
        # order 2 wins only when d1 exceeds the 8-bit tier while d2 (an
        # extra factor omega smaller) lands below it: keep the tone loud
        shift = int(rng.integers(0, 2))
    # ~1/3 of stereo cases correlate the channels (shared base + small
    # per-channel noise): the mid/side wire only wins there, so without
    # these the "m" kind would never be covered
    correlated = channels == 2 and rng.integers(0, 3) == 0
    # ~1/5 of the rest walk with UNIFORM deltas (x = cumsum of uniform
    # noise): every rice parameter costs >= width+1.5 bits/sample on
    # incompressible deltas, so the fixed-width "w" wire wins the byte
    # race — without this class the rice orders 3/4 sweep "w" out of
    # the 25-iteration coverage gate
    walk = not correlated and not tonal and rng.integers(0, 5) == 0
    walk_width = int(rng.integers(7, 11))
    interleaved = np.zeros(signal_len * channels, dtype=np.int32)
    base = None
    for ch in range(channels):
        if correlated and ch == 1:
            spread = max(1, int(rng.integers(1, 64)))
            x = base + rng.integers(-spread, spread, signal_len)
            lim = 1 << (bps - 1)
            x = np.clip(x, -lim, lim - 1).astype(np.int64)
        elif walk:
            lim = 1 << (bps - 1)
            d = rng.integers(-(1 << (walk_width - 1)),
                             1 << (walk_width - 1), signal_len)
            x = np.cumsum(d)
            # reflect at the rails so deltas stay uniform walk_width-bit
            x = np.abs((x + lim) % (4 * lim) - 2 * lim) - lim
            x = np.clip(x, -lim, lim - 1)
            shift = 0
        elif tonal:
            # noise-free smooth tone: higher-order deltas shrink by
            # ~omega per level, steering the scan to orders 2-4
            x = sigen.Sine(
                int(rng.integers(150, 1200)), float(rng.uniform(0.5, 0.95)),
                float(rng.uniform(0, 6.28)),
            ).to_vec_quantized(bps, signal_len)
        else:
            x = random_signal_gen(rng).to_vec_quantized(bps, signal_len)
        x = x >> shift
        if not (correlated and ch == 1) and rng.integers(0, 3) == 0:
            # splice full-scale noise into a random span so delta fit
            # flips between batches (exercises the mid-stream fallback
            # and the multi-program path)
            a = int(rng.integers(0, signal_len))
            b = int(rng.integers(a, signal_len))
            full = 1 << (bps - 1)
            x[a:b] = rng.integers(-full, full, b - a, dtype=np.int64)
        if correlated and ch == 0:
            base = x.copy()
        interleaved[ch::channels] = x
    # record which wire each 4-block batch would select (coverage
    # witness): None (raw), ("w", order, width), ("r", order, p, Wu), or
    # ("m", om, pm, wum, os, ps, wus). Shaped (B, C, T) exactly like the
    # pipeline's chunks — the ms wire reads axis 1 as channels.
    nb = signal_len // block_size
    for i in range(0, max(nb, 1), 4):
        blocks = interleaved.reshape(-1, channels).T[
            :, i * block_size:(i + 4) * block_size
        ]
        if blocks.shape[1] and blocks.shape[1] % block_size == 0:
            out = upack.try_pack(
                blocks.reshape(channels, -1, block_size).transpose(1, 0, 2),
                bps,
            )
            one_upload_case.formats_seen.add(out[0] if out else None)
    # default config only: this tier tests WIRE transparency, and every
    # (config, wire) pair is a fresh jit compile — config interplay is
    # the --device tier's job (keeps a 25-case run minutes, not tens)
    cfg = config.Encoder().into_verified()
    src = lambda: source.MemSource(interleaved, channels, bps, 44100)
    raw = be.encode_with_fixed_block_size(
        cfg, src(), block_size, batch_size=4, upload_pack=False,
    ).to_bytes()
    packed = be.encode_with_fixed_block_size(
        cfg, src(), block_size, batch_size=4, upload_pack=True,
    ).to_bytes()
    assert packed == raw, f"packed-upload bytes diverged (seed={seed})"
    if bps <= 16:
        # the ("d", order) delta16 wire has no fallback: every 16-bit
        # case covers it (hi-res input must REJECT it instead)
        delta = be.encode_with_fixed_block_size(
            cfg, src(), block_size, batch_size=4, upload_pack="delta",
        ).to_bytes()
        assert delta == raw, f"delta-wire bytes diverged (seed={seed})"
        one_upload_case.formats_seen.add(("d", 2))
    else:
        try:
            be.encode_with_fixed_block_size(
                cfg, src(), block_size, batch_size=4, upload_pack="delta",
            )
            raise AssertionError(
                f"delta wire accepted bps={bps} (seed={seed})"
            )
        except ValueError:
            pass
    assert np.array_equal(decode_stream(parse_stream(raw)), interleaved)


one_upload_case.formats_seen = set()


def one_cli_case(seed: int) -> None:
    """End-to-end CLI property: random WAV (channels/bps/rate/length) and
    random flag combinations -> encode -> decode -> sample-exact WAV,
    mirroring the reference CLI matrix (flacenc-bin/src/main.rs:571-696)."""
    import os
    import tempfile

    from flacenc_tpu.cli import main as cli_main
    from flacenc_tpu.wav import read_wav, write_wav

    rng = np.random.default_rng(seed)
    channels = int(rng.integers(1, 4))
    bps = int(rng.choice([8, 16, 24]))
    rate = int(rng.choice([8000, 16001, 44100, 95800]))
    n = int(rng.integers(100, 4000))
    x = np.zeros(n * channels, dtype=np.int32)
    for ch in range(channels):
        x[ch::channels] = random_signal_gen(rng).to_vec_quantized(bps, n)
    with tempfile.TemporaryDirectory() as d:
        wav_in = os.path.join(d, "in.wav")
        flac = os.path.join(d, "out.flac")
        wav_out = os.path.join(d, "back.wav")
        write_wav(wav_in, x, channels, bps, rate)
        args = ["encode", wav_in, "-o", flac]
        if rng.integers(0, 2):
            args += ["--block-size", str(int(rng.choice([256, 1024, 4096])))]
        if rng.integers(0, 3) == 0:
            args += ["--cpu-only"]
        if rng.integers(0, 3) == 0:
            args += ["--strict-float"]
        assert cli_main(args) == 0, f"encode rc != 0 (seed={seed})"
        assert cli_main(["decode", flac, "-o", wav_out]) == 0, (
            f"decode rc != 0 (seed={seed})"
        )
        y, ch2, bps2, rate2 = read_wav(wav_out)
        assert (ch2, bps2, rate2) == (channels, bps, rate), f"header (seed={seed})"
        assert np.array_equal(y, x), f"samples (seed={seed})"


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--iters", type=int, default=100)
    ap.add_argument("--seed", type=int, default=None, help="replay one case")
    ap.add_argument("--max-block", type=int, default=4096)
    ap.add_argument("--start", type=int, default=0)
    ap.add_argument(
        "--device", action="store_true",
        help="fuzz the batched device encoder against the oracle (byte-equal)",
    )
    ap.add_argument(
        "--strict", action="store_true",
        help="with --device: use strict-float QLPC in both encoders",
    )
    ap.add_argument(
        "--mutate", action="store_true",
        help="fuzz the parser with mutated/truncated streams",
    )
    ap.add_argument(
        "--upload", action="store_true",
        help="fuzz packed-upload wire-format transparency (bytes equal)",
    )
    ap.add_argument(
        "--cli", action="store_true",
        help="fuzz the CLI encode/decode round trip with random flags",
    )
    args = ap.parse_args()
    if args.mutate:
        case = one_mutation_case
    elif args.cli:
        case = one_cli_case
    elif args.upload:
        case = one_upload_case
    elif args.device:
        case = lambda i: one_device_case(i, strict=args.strict)
    else:
        case = lambda i: one_case(i, args.max_block)
    if args.seed is not None:
        case(args.seed)
        print(f"seed {args.seed} ok")
        return 0
    for i in range(args.start, args.start + args.iters):
        try:
            case(i)
        except Exception:
            flag = (" --mutate" if args.mutate else
                    " --cli" if args.cli else
                    " --upload" if args.upload else
                    " --device" if args.device else "")
            print(f"FUZZ FAILURE at seed={i}; replay: python fuzz/run_fuzz.py{flag} --seed {i}")
            raise
        if i % 10 == 0:
            print(f"... {i - args.start + 1}/{args.iters}", flush=True)
    if args.upload:
        seen = one_upload_case.formats_seen
        print(f"wire formats covered: {sorted(seen, key=repr)}")
        if args.iters >= 25:
            # a full run must sweep the adaptive matrix: raw fallback,
            # both wire kinds (rice + fixed width), both delta orders,
            # and a spread of rice parameters
            assert None in seen, "raw-fallback batches never exercised"
            kinds = {f[0] for f in seen if f}
            assert kinds == {"r", "w", "d", "m"}, \
                f"wire kinds covered: {kinds}"
            orders = {f[1] for f in seen if f}
            # noise-free tones now land on orders 3/4 (each extra
            # differencing level is another factor omega smaller), the
            # noisy tiers on 1/2 — a full sweep must see both regimes
            assert {1, 2} <= orders and orders - {1, 2, 3, 4} == set(), \
                f"delta orders covered: {orders}"
            assert orders & {3, 4}, f"high orders never won: {orders}"
            rice_ps = {f[2] for f in seen if f and f[0] == "r"}
            assert len(rice_ps) >= 3, f"rice params covered: {rice_ps}"
    print(f"{args.iters} cases passed")
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""On-card smoke test of the batched encoder (one process, one JAX client).

Drives the main path through the entry points a user calls, at
deployment size, on the GPU, and checks every result against the repo's
own references:

1. device      — the first JAX device must be a GPU (never falls back);
2. stream      — 10 min of 16-bit/44.1 kHz stereo through
                 `flacenc_tpu.encode_with_fixed_block_size`, checked with
                 both decoders and the STREAMINFO MD5; the C++ packer
                 ("native2") must be the one in use;
3. strict      — the same audio in strict mode; a 30 s slice must equal
                 the scalar oracle byte for byte; default bits/sample
                 within 0.1% of strict;
4. surfaces    — the CLI (encode + decode of a 4 min WAV), `encode_corpus`
                 on 8 WAVs, a 24-bit/96 kHz stream, a direct-MSE stream;
5. kernels     — each device op against `ops/ref_np.py` at B=64 and
                 B=256, C=4 stereo candidates, T=4096; the compiled HLO
                 is read for matrix products and their types;
6. divergence  — the fuzz device tier (100 seeds) against the oracle;
7. timing      — compile, end-to-end, device step, memory and Rice-search
                 times, for the record (not claims).

The last stdout line is `{"ok": true, "device": {...}}`; any failed
check raises and exits non-zero without it.

Usage:
    python chip_smoke.py           # one GPU
    python chip_smoke.py --multi   # four GPUs: mesh="auto" vs one card
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import re
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "fuzz"))

import numpy as np

import bench
import flacenc_tpu
from flacenc_tpu import config, native
from flacenc_tpu.component import decode_stream, parse_stream
from flacenc_tpu.native import independent
from flacenc_tpu.source import MemSource, samples_to_le_bytes

RATE, BPS, BLOCK = 44100, 16, 4096
STREAM_SECONDS = 600.0
_T0 = time.perf_counter()


def log(msg: str) -> None:
    print(f"[{time.perf_counter() - _T0:7.1f}s] {msg}", flush=True)


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def check_lossless(name: str, data: bytes, x: np.ndarray) -> None:
    """Both decoders give back `x`, and STREAMINFO's MD5 is x's MD5."""
    parsed = parse_stream(data)  # CRC-verified
    info = parsed.stream_info()
    require(np.array_equal(decode_stream(parsed), x),
            f"{name}: component decoder differs from the input")
    require(np.array_equal(independent.decode_stream(data).samples, x),
            f"{name}: clean-room decoder differs from the input")
    md5 = hashlib.md5(
        samples_to_le_bytes(x, -(-info.bits_per_sample // 8))).digest()
    require(info.md5 == md5, f"{name}: STREAMINFO MD5 mismatch")


def bits_per_sample(data: bytes, x: np.ndarray) -> float:
    return len(data) * 8 / len(x)


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


def phase_device():
    import jax

    dev = jax.devices()[0]
    require(dev.platform == "gpu",
            f"JAX found no GPU (first device platform {dev.platform!r})")
    card = bench.card_info()
    log(f"device_kind: {dev.device_kind}")
    log(f"device count: {len(jax.devices())}")
    log(f"jax: {jax.__version__}")
    log(f"card: {card}")
    return dev, card


def phase_stream(cfg, audio):
    require(native.available(), f"native packer unavailable: {native._load_error!r}")
    out = {}
    for label in ("cold", "warm"):
        stats = {}
        t0 = time.perf_counter()
        data = flacenc_tpu.encode_with_fixed_block_size(
            cfg, MemSource(audio, 2, BPS, RATE), BLOCK, stats=stats,
        ).to_bytes()
        out[label] = (time.perf_counter() - t0, data, stats)
    (cold_s, data, stats), (warm_s, data_w, stats_w) = out["cold"], out["warm"]
    require(data_w == data, "warm re-encode differs from the cold encode")
    require(stats["packer"] == "native2",
            f"packer in use is {stats['packer']!r}, not 'native2'")
    check_lossless("stream", data, audio)
    bps = bits_per_sample(data, audio)
    log(f"stream: {len(audio) // 2 // BLOCK} blocks, {stats['batches']} "
        f"batches, packer {stats['packer']}, {bps:.6f} bits/sample, "
        f"wire batches {stats['wire_batches']}, grouped batches "
        f"{stats['grouped_batches']}; lossless (both decoders) + MD5 OK")
    return bps, cold_s, warm_s, stats_w


def phase_strict(cfg, audio, default_bps):
    from flacenc_tpu.models import reference_encoder

    data = flacenc_tpu.encode_with_fixed_block_size(
        cfg, MemSource(audio, 2, BPS, RATE), BLOCK, strict_lpc=True,
    ).to_bytes()
    check_lossless("strict stream", data, audio)
    strict_bps = bits_per_sample(data, audio)
    log(f"strict: {strict_bps:.6f} bits/sample; default {default_bps:.6f} "
        f"({(default_bps / strict_bps - 1) * 100:+.4f}%)")
    require(default_bps <= strict_bps * 1.001,
            "default bits/sample more than 0.1% above strict")
    part = audio[: int(30 * RATE) * 2]
    dev = flacenc_tpu.encode_with_fixed_block_size(
        cfg, MemSource(part, 2, BPS, RATE), BLOCK, strict_lpc=True,
    ).to_bytes()
    ref = reference_encoder.encode_with_fixed_block_size(
        cfg, MemSource(part, 2, BPS, RATE), BLOCK, strict_lpc=True,
    ).to_bytes()
    require(dev == ref, "strict 30 s slice differs from the scalar oracle")
    log(f"strict: 30 s slice byte-equal to the scalar oracle "
        f"({len(dev)} bytes)")
    return strict_bps


def phase_surfaces(cfg, audio, tmp):
    from flacenc_tpu import cli
    from flacenc_tpu.parallel import encode_corpus
    from flacenc_tpu.wav import WavFileSource, read_wav, write_wav

    # CLI: encode + decode a 4 min WAV
    x = audio[: int(240 * RATE) * 2]
    wav, flac, back = (os.path.join(tmp, n)
                       for n in ("cli.wav", "cli.flac", "cli_back.wav"))
    write_wav(wav, x, 2, BPS, RATE)
    require(cli.main(["encode", wav, "-o", flac]) == 0, "cli encode rc")
    require(cli.main(["decode", flac, "-o", back]) == 0, "cli decode rc")
    y, ch, bits, rate = read_wav(back)
    require((ch, bits, rate) == (2, BPS, RATE) and np.array_equal(y, x),
            "cli decode WAV differs from the encoded WAV")
    with open(flac, "rb") as f:
        check_lossless("cli", f.read(), x)
    log("surfaces: CLI encode/decode of a 4 min WAV round-trips")

    # corpus: 8 WAVs of mixed lengths
    sources, originals = _corpus_wavs(audio, tmp)
    streams, cstats = encode_corpus(
        [(p, WavFileSource(p)) for p in sources], cfg, BLOCK)
    for p in sources:
        check_lossless(f"corpus {os.path.basename(p)}",
                       streams[p].to_bytes(), originals[p])
    log(f"surfaces: encode_corpus on {len(sources)} WAVs "
        f"({cstats.frames} frames, {cstats.batches} batches) round-trips")

    # 24-bit / 96 kHz stereo (the int32 upload)
    rng = np.random.default_rng(24)
    hi = bench.make_audio(30.0, 96000).astype(np.int64) * 256
    hi += rng.integers(-128, 128, hi.shape)
    hi = np.clip(hi, -(1 << 23), (1 << 23) - 1).astype(np.int32)
    data = flacenc_tpu.encode_with_fixed_block_size(
        cfg, MemSource(hi, 2, 24, 96000), BLOCK).to_bytes()
    check_lossless("24/96", data, hi)
    log(f"surfaces: 24-bit/96 kHz stream lossless, "
        f"{bits_per_sample(data, hi):.4f} bits/sample")

    # experimental direct-MSE LPC (f64 einsum + Cholesky while_loop)
    mse = config.Encoder()
    mse.subframe_coding.qlpc.use_direct_mse = True
    x = audio[: int(30 * RATE) * 2]
    data = flacenc_tpu.encode_with_fixed_block_size(
        mse.into_verified(), MemSource(x, 2, BPS, RATE), BLOCK).to_bytes()
    check_lossless("direct-MSE", data, x)
    log(f"surfaces: direct-MSE stream lossless, "
        f"{bits_per_sample(data, x):.4f} bits/sample")


def _corpus_wavs(audio, tmp):
    from flacenc_tpu.wav import write_wav

    sources, originals = [], {}
    for i, secs in enumerate((3, 7, 15, 30, 45, 60, 120, 240)):
        start = int(i * 11 * RATE) * 2
        x = audio[start: start + int(secs * RATE) * 2]
        p = os.path.join(tmp, f"corpus_{i}_{secs}s.wav")
        write_wav(p, x, 2, BPS, RATE)
        sources.append(p)
        originals[p] = x
    return sources, originals


def _kernel_inputs(audio, n_blocks):
    """(n_blocks, 4, T) int32 stereo candidates (L, R, M, S) from blocks
    spread over the stream."""
    from flacenc_tpu.models import batch_encoder as be

    total = len(audio) // 2 // BLOCK
    idx = np.linspace(0, total - 1, n_blocks).astype(int)
    blocks = audio[: total * BLOCK * 2].reshape(total, BLOCK, 2)[idx]
    return be._candidate_signals(
        np.ascontiguousarray(blocks.transpose(0, 2, 1)), 2)


def phase_kernels(cfg, audio, widths=(64, 256)):
    """Each device op against ops/ref_np.py on the same inputs."""
    import jax
    import jax.numpy as jnp

    from flacenc_tpu.ops import fixed as oF, lpc as oL, rice as oR, ref_np
    from flacenc_tpu.ops.windows import get_window

    sub = cfg.inner.subframe_coding
    order, prec = sub.qlpc.lpc_order, sub.qlpc.quant_precision
    parts, max_p = sub.fixed.order_sel.partitions, sub.prc.max_parameter
    window = get_window(sub.qlpc.window, BLOCK)
    finest = oR.finest_partition_order(BLOCK, 64)
    n_max = max(widths)
    sig_all = _kernel_inputs(audio, n_max)  # (n_max, 4, T)
    rows = sig_all.reshape(-1, BLOCK)

    # plain reference, row by row (rows of the widest batch)
    t0 = time.perf_counter()
    ref = {k: [] for k in ("fixed", "ent", "win", "corr")}
    for s in rows:
        fx = ref_np.fixed_lpc_errors(s)
        ref["fixed"].append(np.stack(fx))
        ref["ent"].append([ref_np.estimate_entropy(fx[o], o, parts)
                           for o in range(5)])
        w = ref_np.windowed_signal(s, sub.qlpc.window)
        ref["win"].append(w)
        ref["corr"].append(ref_np.auto_correlation(order + 1, w))
    ref = {k: np.asarray(v) for k, v in ref.items()}
    log(f"kernels: plain reference over {len(rows)} rows in "
        f"{time.perf_counter() - t0:.1f} s")

    @jax.jit
    def front(sig):
        fixed = oF.fixed_lpc_errors(sig)
        warm = jnp.broadcast_to(jnp.arange(5, dtype=jnp.int32), fixed.shape[:-1])
        ent = oF.estimate_entropy(fixed, warm, parts, BLOCK)
        win = oL.apply_window(sig, window)
        return fixed, ent, win, oL.auto_correlation(win, order)

    lev = jax.jit(lambda c: oL.levinson(c, order))
    quant = jax.jit(lambda c: oL.quantize_parameters(c, prec))
    fir = jax.jit(lambda q, o, s, x: oL.compute_error(q, o, s, x, max_taps=order))
    tables = jax.jit(lambda e, w: oR._finest_tables(
        oR.encode_signbit(e), w, finest, BLOCK))
    search = jax.jit(lambda e, w: oR.find_partitioned_rice_parameters(
        e, w, BLOCK, max_p))

    results = []
    for B in widths:
        n = B * 4
        sig = jnp.asarray(sig_all[:B])
        fixed, ent, win, corr = jax.device_get(front(sig))
        corr_f = corr.reshape(n, -1)
        coefs = np.asarray(jax.device_get(lev(jnp.asarray(corr))))
        q, q_order, q_shift = jax.device_get(quant(jnp.asarray(coefs)))
        err = np.asarray(jax.device_get(fir(jnp.asarray(q), jnp.asarray(q_order),
                                            jnp.asarray(q_shift), sig)))
        tab = np.asarray(jax.device_get(tables(jnp.asarray(err), jnp.asarray(q_order))))
        rs = jax.device_get(search(jnp.asarray(err), jnp.asarray(q_order)))

        r = {}
        r["fixed cascade (exact)"] = int(np.sum(
            fixed.reshape(n, 5, BLOCK) != ref["fixed"][:n]))
        r["apply_window (exact)"] = int(np.sum(
            win.reshape(n, BLOCK).view(np.uint32) != ref["win"][:n].view(np.uint32)))
        cref = ref["corr"][:n]
        r["auto_correlation (f64 rel <= 1e-12)"] = float(np.max(
            np.abs(corr_f - cref) / np.maximum(np.abs(cref[:, :1]), 1e-300)))
        coefs_f = coefs.reshape(n, order)
        lev_err, q_bad, q_ties, fir_bad, tab_bad, rice_bad = 0.0, 0, 0, 0, 0, 0
        q_f, qo_f, qs_f = (a.reshape(n, -1) for a in (q, q_order, q_shift))
        err_f, tab_f = err.reshape(n, BLOCK), tab.reshape(n, -1, 32)
        rs_order = rs.partition_order.reshape(n)
        rs_params = rs.params.reshape(n, -1)
        rs_bits = rs.code_bits.reshape(n)
        for i in range(n):
            lr = ref_np.symmetric_levinson_recursion(
                corr_f[i, :order], corr_f[i, 1:order + 1])
            lev_err = max(lev_err, float(
                np.max(np.abs(coefs_f[i] - lr)) / max(np.max(np.abs(lr)), 1e-300)))
            rq, ro, rsh = ref_np.quantize_parameters(coefs_f[i], prec)
            if (ro, rsh) != (int(qo_f[i, 0]), int(qs_f[i, 0])) or not np.array_equal(
                    q_f[i, :ro], rq):
                scaled = np.abs(coefs_f[i] * 2.0 ** rsh)
                if np.min(np.abs(scaled - np.floor(scaled) - 0.5)) < 1e-9:
                    q_ties += 1
                else:
                    q_bad += 1
            re_ = ref_np.compute_error(rq, rsh, rows[i])
            fir_bad += int(np.sum(err_f[i] != re_))
            z = ref_np.encode_signbit(re_)
            plen = BLOCK >> finest
            for p in range(1 << finest):
                start = max(p * plen, ro)
                if not np.array_equal(tab_f[i, p],
                                      ref_np.prc_bit_table(z[start:(p + 1) * plen], 4)):
                    tab_bad += 1
            prc = ref_np.find_partitioned_rice_parameter(re_, ro, max_p)
            if (int(rs_order[i]) != prc.order
                    or not np.array_equal(rs_params[i, :1 << prc.order], prc.ps)
                    or int(rs_bits[i]) != prc.code_bits):
                rice_bad += 1
        r["levinson (f64 rel <= 1e-9)"] = lev_err
        r["quantize_parameters (exact; ties counted)"] = q_bad
        r["compute_error (exact i64)"] = fir_bad
        r["rice finest tables (exact)"] = tab_bad
        r["rice search (exact)"] = rice_bad
        ent_diff = int(np.sum(ent.reshape(n, 5) != ref["ent"][:n]))
        ent_share = ent_diff / (n * 5)
        r["estimate_entropy (f32; share differing <= 0.1%)"] = ent_share

        log(f"kernels B={B}: {n} rows (block, channel), T={BLOCK}")
        for k, v in r.items():
            log(f"  {k}: {v}")
        log(f"  quantize rounding ties: {q_ties}; entropy estimates "
            f"differing: {ent_diff} of {n * 5}")
        require(r["fixed cascade (exact)"] == 0, "fixed cascade")
        require(r["apply_window (exact)"] == 0, "apply_window")
        require(r["auto_correlation (f64 rel <= 1e-12)"] <= 1e-12, "auto_correlation")
        require(lev_err <= 1e-9, "levinson")
        require(q_bad == 0, "quantize_parameters")
        require(fir_bad == 0, "compute_error")
        require(tab_bad == 0, "rice tables")
        require(rice_bad == 0, "rice search")
        require(ent_share <= 0.001, "estimate_entropy share")
        results.append((B, r, q_ties, ent_diff))
    return results


def phase_hlo(cfg):
    """Matrix products in the compiled steps, with their element types:
    the default step must have none in float32 (TF32 would touch those)."""
    import jax
    import jax.numpy as jnp

    from flacenc_tpu.models import batch_encoder as be

    mse = config.Encoder()
    mse.subframe_coding.qlpc.use_direct_mse = True
    found = {}
    for name, c in (("default", cfg.inner), ("direct-MSE", mse)):
        fn = be._cached_encoder_fn(c.to_toml(), 2, BPS, BLOCK, decisions_only=True)
        text = fn.lower(jax.ShapeDtypeStruct((64, 2, BLOCK), jnp.int16)).compile().as_text()
        mm = [ln.strip() for ln in text.splitlines()
              if re.search(r"\bdot\(|gemm|cublas|convolution\(", ln)]
        types = sorted({t for ln in mm for t in re.findall(
            r"\b(f8\w*|bf16|f16|f32|f64|s8|s32)\[", ln)})
        log(f"hlo {name}: {len(mm)} matrix-product lines, element types {types}")
        for ln in mm[:6]:
            log(f"  {ln[:220]}")
        require(not any(t in ("f32", "bf16", "f16") or t.startswith("f8")
                        for t in types),
                f"{name} step has a low-precision matrix product")
        found[name] = (len(mm), types)
    return found


def phase_divergence(n_seeds=100):
    import run_fuzz

    diverged = [s for s in range(n_seeds) if run_fuzz.one_device_case(s)]
    log(f"divergence: fuzz device tier, {n_seeds} seeds: {len(diverged)} "
        f"differ from the oracle in bytes {diverged} (each lossless and "
        f"resolved by strict mode)")
    return diverged


def phase_timing(cfg, audio, card, cold_s, warm_s):
    import jax
    import jax.numpy as jnp

    from flacenc_tpu.models import batch_encoder as be
    from flacenc_tpu.ops import rice as oR

    audio_s = len(audio) / 2 / RATE
    log(f"timing [{card}]: 10 min stream cold {cold_s:.3f} s "
        f"({audio_s / cold_s:.1f}x realtime), warm {warm_s:.3f} s "
        f"({audio_s / warm_s:.1f}x realtime)")
    fn = be._cached_encoder_fn(cfg.inner.to_toml(), 2, BPS, BLOCK,
                               decisions_only=True)
    spec = jax.ShapeDtypeStruct((256, 2, BLOCK), jnp.int16)
    t0 = time.perf_counter()
    compiled = fn.lower(spec).compile()
    t_cold = time.perf_counter() - t0
    jax.clear_caches()  # the next compile loads from the persistent cache
    t0 = time.perf_counter()
    fn.lower(spec).compile()
    t_warm = time.perf_counter() - t0
    log(f"timing [{card}]: B=256 step compile cold {t_cold:.3f} s, "
        f"warm {t_warm:.3f} s (persistent cache "
        f"{os.environ.get('JAX_COMPILATION_CACHE_DIR') or 'checkout .jax_cache'})")
    log(f"timing [{card}]: B=256 step memory_analysis: "
        f"{compiled.memory_analysis()}")
    blocks = jnp.asarray(_kernel_inputs(audio, 256)[:, :2].astype(np.int16))
    step = bench.device_step_ms(fn, (blocks,))
    log(f"timing [{card}]: B=256 device step {step:.3f} ms/batch "
        f"({256 * BLOCK / RATE / (step / 1e3):.1f}x realtime, chained)")
    err = jnp.asarray(np.random.default_rng(0).integers(
        -3000, 3000, (256, 4, BLOCK), dtype=np.int32))
    warm = jnp.full((256, 4), 10, jnp.int32)
    rice = jax.jit(lambda e, w: oR.find_partitioned_rice_parameters(e, w, BLOCK, 30))
    rice_ms = bench.device_step_ms(rice, (err, warm))
    log(f"timing [{card}]: find_partitioned_rice_parameters (256, 4, 4096) "
        f"{rice_ms:.3f} ms ({rice_ms / step * 100:.1f}% of the step time; "
        f"the step searches 2 such sets: fixed and LPC residuals)")


def run_multi(cfg, audio):
    """4 cards: mesh="auto" against mesh=None on one card, byte for byte."""
    import jax

    from flacenc_tpu.models import batch_encoder as be
    from flacenc_tpu.parallel import encode_corpus
    from flacenc_tpu.wav import WavFileSource

    require(len(jax.local_devices()) == 4,
            f"--multi needs 4 GPUs, found {len(jax.local_devices())}")
    timings = {}
    for mesh in ("auto", None):
        stats = {}
        t0 = time.perf_counter()
        data = be.encode_with_fixed_block_size(
            cfg, MemSource(audio, 2, BPS, RATE), BLOCK, mesh=mesh,
            stats=stats).to_bytes()
        timings[mesh] = (time.perf_counter() - t0, data)
    require(timings["auto"][1] == timings[None][1],
            "mesh='auto' stream differs from the one-card stream")
    check_lossless("multi stream", timings["auto"][1], audio)
    log(f"multi: 10 min stream on 4 cards equals one card "
        f"(first encodes, compile included: auto {timings['auto'][0]:.3f} s, "
        f"one card {timings[None][0]:.3f} s)")
    with tempfile.TemporaryDirectory() as tmp:
        sources, originals = _corpus_wavs(audio, tmp)
        outs = {}
        for mesh in ("auto", None):
            streams, _ = encode_corpus(
                [(p, WavFileSource(p)) for p in sources], cfg, BLOCK,
                mesh=mesh)
            outs[mesh] = {p: streams[p].to_bytes() for p in sources}
        require(outs["auto"] == outs[None],
                "mesh='auto' corpus differs from the one-card corpus")
        for p in sources:
            check_lossless(f"multi corpus {p}", outs["auto"][p], originals[p])
    log("multi: encode_corpus on 4 cards equals one card")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--multi", action="store_true",
                    help="only the 4-card mesh='auto' path against one card")
    args = ap.parse_args(argv)
    import jax

    dev, card = phase_device()
    cfg = config.Encoder().into_verified()
    audio = bench.make_audio(STREAM_SECONDS, RATE)
    if args.multi:
        run_multi(cfg, audio)
    else:
        default_bps, cold_s, warm_s, _ = phase_stream(cfg, audio)
        phase_strict(cfg, audio, default_bps)
        with tempfile.TemporaryDirectory() as tmp:
            phase_surfaces(cfg, audio, tmp)
        phase_kernels(cfg, audio)
        phase_hlo(cfg)
        phase_divergence()
        phase_timing(cfg, audio, card, cold_s, warm_s)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

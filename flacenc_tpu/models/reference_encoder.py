"""Scalar (numpy) frame encoder — the semantics oracle.

Mirrors the controller logic of ``/root/reference/src/coding.rs`` exactly:
subframe candidate generation (Constant/Fixed/LPC/Verbatim), order selection
(BitCount or ApproxEnt), Rice parameter search, and the four-way stereo-mode
search. Used as the parity oracle for the batched device encoder and as the
encode path for tail blocks.
"""

from __future__ import annotations

from typing import Iterable, List, Optional, Tuple

import numpy as np

from .. import config as config_mod
from .. import constants
from ..component.datatype import (
    BlockSizeSpec,
    ChannelAssignment,
    Constant,
    FixedLpc,
    Frame,
    FrameHeader,
    Lpc,
    QuantizedParameters,
    Residual,
    SampleRateSpec,
    SampleSizeSpec,
    Stream,
    SubFrame,
    Verbatim,
)
from ..errors import RangeError, Verified
from ..ops import ref_np
from ..source import Context, FrameBuf, Source


def encode_residual_with_prc_parameter(
    errors: np.ndarray, warmup_length: int, prc_p: ref_np.PrcParameter
) -> Residual:
    """coding.rs:140-170."""
    q, r = ref_np.quotients_and_remainders(errors, prc_p, warmup_length)
    return Residual(
        prc_p.order, len(errors), warmup_length, prc_p.ps, q, r
    )


def encode_residual(
    prc_config: config_mod.Prc, errors: np.ndarray, warmup_length: int
) -> Residual:
    """coding.rs:173-176."""
    prc_p = ref_np.find_partitioned_rice_parameter(
        errors, warmup_length, prc_config.max_parameter
    )
    return encode_residual_with_prc_parameter(errors, warmup_length, prc_p)


def select_order_and_encode_residual(
    order_sel: config_mod.OrderSel,
    prc_config: config_mod.Prc,
    errors: Iterable[Tuple[int, np.ndarray]],
    bits_per_sample: int,
    baseline_bits: int,
    strict_lpc: bool = False,
) -> Optional[Tuple[int, Residual]]:
    """coding.rs:230-288. Ties prefer the lowest order (first minimum).

    With `strict_lpc`, the ApproxEnt estimate uses the native sequential-f32
    accumulation matching the reference STABLE build exactly (fakesimd's
    find_sum_abs_f32 is a scalar loop, arrayutils.rs:427-438); the default
    numpy estimate uses pairwise summation, which can flip order choices on
    adversarial inputs (COVERAGE.md deviation list).
    """
    max_rice_p = prc_config.max_parameter
    if order_sel.type == "BitCount":
        best = None
        for order, err in errors:
            prc_p = ref_np.find_partitioned_rice_parameter(err, order, max_rice_p)
            bits = bits_per_sample * order + prc_p.code_bits
            if best is None or bits < best[3]:
                best = (order, err, prc_p, bits)
        if best is None or best[3] >= baseline_bits:
            return None
        order, err, prc_p, _ = best
        return order, encode_residual_with_prc_parameter(err, order, prc_p)
    else:  # ApproxEnt
        if strict_lpc:
            from .. import native

            def entropy(err, order):
                est = native.estimate_entropy_strict(
                    err, order, order_sel.partitions
                )
                if est is None:
                    raise RuntimeError(
                        "strict mode requires the native library; "
                        "run `python flacenc_tpu/native/build.py`"
                    )
                return est
        else:
            def entropy(err, order):
                return ref_np.estimate_entropy(err, order, order_sel.partitions)

        best = None
        for order, err in errors:
            bits = entropy(err, order) + bits_per_sample * order
            if best is None or bits < best[2]:
                best = (order, err, bits)
        if best is None or best[2] >= baseline_bits:
            return None
        order, err, _ = best
        return order, encode_residual(prc_config, err, order)


def fixed_lpc(
    cfg: config_mod.SubFrameCoding,
    signal: np.ndarray,
    bits_per_sample: int,
    baseline_bits: int,
    strict_lpc: bool = False,
) -> Optional[FixedLpc]:
    """coding.rs:298-331."""
    assert bits_per_sample < 30
    max_order = cfg.fixed.max_order
    errors = ref_np.fixed_lpc_errors(signal, constants.fixed.MAX_LPC_ORDER)
    sel = select_order_and_encode_residual(
        cfg.fixed.order_sel,
        cfg.prc,
        list(enumerate(errors[: max_order + 1])),
        bits_per_sample,
        baseline_bits,
        strict_lpc,
    )
    if sel is None:
        return None
    order, residual = sel
    return FixedLpc(signal[:order], residual, bits_per_sample)


def perform_qlpc(cfg: config_mod.SubFrameCoding, signal: np.ndarray) -> np.ndarray:
    """LPC estimation method dispatch (coding.rs:333-351).

    The reference gates direct-MSE/IRLS-MAE behind its `experimental`
    feature; this framework always ships them.
    """
    q = cfg.qlpc
    if q.use_direct_mse:
        if q.mae_optimization_steps > 0:
            return ref_np.lpc_with_irls_mae(
                signal, q.window, q.lpc_order, q.mae_optimization_steps
            )
        return ref_np.lpc_with_direct_mse(signal, q.window, q.lpc_order)
    return ref_np.lpc_from_autocorr(signal, q.window, q.lpc_order)


def estimated_qlpc(
    cfg: config_mod.SubFrameCoding, signal: np.ndarray, bits_per_sample: int,
    strict_lpc: bool = False,
) -> Lpc:
    """coding.rs:360-381."""
    lpc_order = cfg.qlpc.lpc_order
    if strict_lpc and not cfg.qlpc.use_direct_mse:
        from .. import native
        from ..ops.windows import get_window

        res = native.strict_qlpc(
            signal[None, :], get_window(cfg.qlpc.window, len(signal)),
            lpc_order, cfg.qlpc.quant_precision,
        )
        if res is None:
            raise RuntimeError(
                "strict mode requires the native library; "
                "run `python flacenc_tpu/native/build.py`"
            )
        q, o, sh = res
        order, shift = int(o[0]), int(sh[0])
        qcoefs = q[0, :order].astype(np.int16)
        errors = ref_np.compute_error(qcoefs, shift, signal)
        residual = encode_residual(cfg.prc, errors, order)
        params = QuantizedParameters(
            qcoefs, order, shift, cfg.qlpc.quant_precision
        )
        return Lpc(signal[:order], params, residual, bits_per_sample)
    coefs = perform_qlpc(cfg, signal)
    qcoefs, order, shift = ref_np.quantize_parameters(
        coefs[:lpc_order], cfg.qlpc.quant_precision
    )
    errors = ref_np.compute_error(qcoefs, shift, signal)
    residual = encode_residual(cfg.prc, errors, order)
    params = QuantizedParameters(qcoefs, order, shift, cfg.qlpc.quant_precision)
    return Lpc(signal[:order], params, residual, bits_per_sample)


def encode_subframe(
    cfg: config_mod.SubFrameCoding, samples: np.ndarray, bits_per_sample: int,
    strict_lpc: bool = False,
) -> SubFrame:
    """Candidate generation + selection (coding.rs:384-418)."""
    if cfg.use_constant and bool((samples == samples[0]).all()):
        return Constant(len(samples), int(samples[0]), bits_per_sample)
    verbatim_bits = Verbatim.count_bits_from_metadata(len(samples), bits_per_sample)
    too_short = len(samples) < constants.MIN_BLOCK_SIZE_FOR_PREDICTION
    fixed = (
        fixed_lpc(cfg, samples, bits_per_sample, verbatim_bits, strict_lpc)
        if (not too_short and cfg.use_fixed)
        else None
    )
    baseline_bits = (
        min(verbatim_bits, fixed.count_bits()) if fixed is not None else verbatim_bits
    )
    est_lpc = None
    if not too_short and cfg.use_lpc:
        candidate = estimated_qlpc(cfg, samples, bits_per_sample, strict_lpc)
        if candidate.count_bits() < baseline_bits:
            est_lpc = candidate
    chosen = est_lpc if est_lpc is not None else fixed
    if chosen is not None and chosen.count_bits() < verbatim_bits:
        return chosen
    return Verbatim(samples, bits_per_sample)


def _new_frame_header(
    block_size: int, ch_info: ChannelAssignment, stream_sample_rate: int, bps: int
) -> FrameHeader:
    rate_spec = SampleRateSpec.from_freq(stream_sample_rate)
    return FrameHeader(
        BlockSizeSpec.from_size(block_size),
        ch_info,
        SampleSizeSpec.from_bits(bps),
        rate_spec if rate_spec is not None else SampleRateSpec.UNSPECIFIED,
    )


def encode_frame_impl(
    config: config_mod.Encoder,
    channels: List[np.ndarray],
    sample_rate: int,
    bits_per_sample: int,
    ch_info: ChannelAssignment,
    strict_lpc: bool = False,
) -> Frame:
    """coding.rs:421-449 (channels are already stereo-transformed)."""
    block_size = len(channels[0])
    header = _new_frame_header(block_size, ch_info, sample_rate, bits_per_sample)
    subframes = []
    for ch, sig in enumerate(channels):
        subframes.append(
            encode_subframe(
                config.subframe_coding,
                sig,
                bits_per_sample + ch_info.bits_per_sample_offset(ch),
                strict_lpc,
            )
        )
    return Frame(header, subframes)


def try_stereo_coding(
    config: config_mod.Encoder,
    channels: List[np.ndarray],
    indep: Frame,
    sample_rate: int,
    bits_per_sample: int,
    strict_lpc: bool = False,
) -> Frame:
    """Four-way L/R vs L/S vs S/R vs M/S search (coding.rs:469-527)."""
    l, r = channels[0].astype(np.int32), channels[1].astype(np.int32)
    mid = ((l.astype(np.int64) + r.astype(np.int64)) >> 1).astype(np.int32)
    side = (l.astype(np.int64) - r.astype(np.int64)).astype(np.int32)
    ms_frame = encode_frame_impl(
        config, [mid, side], sample_rate, bits_per_sample,
        ChannelAssignment.mid_side(), strict_lpc,
    )
    bits_l = indep.subframe(0).count_bits()
    bits_r = indep.subframe(1).count_bits()
    bits_m = ms_frame.subframe(0).count_bits()
    bits_s = ms_frame.subframe(1).count_bits()

    combinations = []
    if config.stereo_coding.use_leftside:
        combinations.append((ChannelAssignment.left_side(), bits_l + bits_s))
    if config.stereo_coding.use_rightside:
        combinations.append((ChannelAssignment.right_side(), bits_r + bits_s))
    if config.stereo_coding.use_midside:
        combinations.append((ChannelAssignment.mid_side(), bits_m + bits_s))

    min_bits = bits_l + bits_r
    min_ch_info = ChannelAssignment.independent(2)
    for ch_info, bits in combinations:
        if bits < min_bits:
            min_bits = bits
            min_ch_info = ch_info

    header = _new_frame_header(
        len(l), min_ch_info, sample_rate, bits_per_sample
    )
    _, sf_l, sf_r = indep.into_stereo_channels()
    _, sf_m, sf_s = ms_frame.into_stereo_channels()
    chans = min_ch_info.select_channels(sf_l, sf_r, sf_m, sf_s)
    return Frame(header, [chans[0], chans[1]])


def encode_frame(
    config: config_mod.Encoder,
    framebuf: FrameBuf,
    sample_rate: int,
    bits_per_sample: int,
    strict_lpc: bool = False,
) -> Frame:
    """coding.rs:530-544."""
    nchannels = framebuf.channels
    channels = [framebuf.channel_slice(ch) for ch in range(nchannels)]
    ch_info = ChannelAssignment.independent(nchannels)
    ret = encode_frame_impl(
        config, channels, sample_rate, bits_per_sample, ch_info, strict_lpc
    )
    if nchannels == 2:
        ret = try_stereo_coding(
            config, channels, ret, sample_rate, bits_per_sample, strict_lpc
        )
    return ret


def encode_fixed_size_frame(
    config: Verified[config_mod.Encoder] | config_mod.Encoder,
    framebuf: FrameBuf,
    frame_number: int,
    stream_info,
    strict_lpc: bool = False,
) -> Frame:
    """Public per-frame entry point (coding.rs:581-606)."""
    cfg = config.inner if isinstance(config, Verified) else config
    if not (0 <= frame_number < (1 << 31)):
        raise RangeError("frame_number", "must fit in 31 bits", frame_number)
    framebuf.verify_samples(stream_info.bits_per_sample)
    frame = encode_frame(
        cfg, framebuf, stream_info.sample_rate, stream_info.bits_per_sample,
        strict_lpc,
    )
    frame.header_mut().set_frame_number(frame_number)
    return frame


def encode_with_variable_block_size(
    config: Verified[config_mod.Encoder] | config_mod.Encoder,
    src: Source,
    block_sizes,
    strict_lpc: bool = False,
) -> Stream:
    """Variable-blocking stream encoder (completeness entry).

    The reference defines, writes, parses, and VERIFIES variable-block
    streams (sample-number frame offsets, datatype.rs:266-314 /
    1204-1215) but ships no encoder entry emitting them; this minimal
    oracle-path entry does: frame i takes its block size from
    `block_sizes[i]` (the final entry repeats until EOF) and carries a
    `FrameOffset::StartSample` header. STREAMINFO keeps the true
    min/max block sizes (no fixed-mode `min=max` finalization,
    coding.rs:678-688 does not apply to variable mode).
    """
    cfg = config.inner if isinstance(config, Verified) else config
    sizes = [int(b) for b in block_sizes]
    if not sizes:
        raise RangeError("block_sizes", "must be non-empty", 0)
    for b in sizes:
        if not (constants.MIN_BLOCK_SIZE <= b <= constants.MAX_BLOCK_SIZE):
            raise RangeError(
                "block_sizes",
                f"must be in [{constants.MIN_BLOCK_SIZE}, "
                f"{constants.MAX_BLOCK_SIZE}]",
                b,
            )
    stream = Stream(src.sample_rate(), src.channels(), src.bits_per_sample())
    context = Context(src.bits_per_sample(), src.channels())
    start_sample = 0
    i = 0
    while True:
        bs = sizes[min(i, len(sizes) - 1)]
        framebuf = FrameBuf(src.channels(), bs)
        read = src.read_samples(bs, (framebuf, context))
        if read == 0:
            break
        frame = encode_fixed_size_frame(
            cfg, framebuf, 0, stream.stream_info(), strict_lpc=strict_lpc
        )
        frame.header_mut().set_start_sample_number(start_sample)
        start_sample += read
        stream.add_frame(frame)
        i += 1
    stream.stream_info_mut().set_md5_digest(context.md5_digest())
    total = src.len_hint()
    stream.stream_info_mut().set_total_samples(
        total if total is not None else context.total_samples()
    )
    return stream


def encode_with_fixed_block_size(
    config: Verified[config_mod.Encoder] | config_mod.Encoder,
    src: Source,
    block_size: int,
    strict_lpc: bool = False,
) -> Stream:
    """Single-block-at-a-time stream encoder (coding.rs:645-695).

    This is the oracle path; `flacenc_tpu.encode_with_fixed_block_size`
    dispatches to the batched device pipeline by default.
    """
    cfg = config.inner if isinstance(config, Verified) else config
    stream = Stream(src.sample_rate(), src.channels(), src.bits_per_sample())
    framebuf = FrameBuf(src.channels(), block_size)
    context = Context(src.bits_per_sample(), src.channels())
    while True:
        read = src.read_samples(block_size, (framebuf, context))
        if read == 0:
            break
        frame = encode_fixed_size_frame(
            cfg, framebuf, context.current_frame_number(), stream.stream_info(),
            strict_lpc=strict_lpc,
        )
        stream.add_frame(frame)
    if stream.frame_count() > 0:
        mx = stream.stream_info().max_block_size
        stream.stream_info_mut().set_block_sizes(mx, mx)
    stream.stream_info_mut().set_md5_digest(context.md5_digest())
    total = src.len_hint()
    stream.stream_info_mut().set_total_samples(
        total if total is not None else context.total_samples()
    )
    return stream

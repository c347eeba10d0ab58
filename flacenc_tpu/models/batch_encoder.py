"""Batched device frame encoder — the flagship pipeline.

Where the reference encodes one frame per thread (``src/par.rs``), this
model encodes a whole batch of blocks as `(B, C, T)` tensors in ONE jitted
device program: every candidate predictor (constant / fixed orders 0-4 /
QLPC) is evaluated for every block, channel, and stereo mode at once, and
selection is a set of exact integer bit-cost argmins reproducing the
reference's decision procedure (``src/coding.rs:384-527``) including
tie-breaking. The host receives chosen parameters + residuals and performs
the bit-serial packing (Python oracle path here; C++ packer on the fast
path).

Stereo candidates are indexed L=0, R=1, M=2, S=3; assignment codes are
0=LR, 1=LS, 2=RS, 3=MS (selection order matches coding.rs:500-522).
"""

from __future__ import annotations

import functools
import os
from typing import List, NamedTuple, Optional, Tuple

import numpy as np

from .. import config as config_mod
from .. import constants
from ..component.datatype import (
    ChannelAssignment,
    Constant,
    FixedLpc,
    Frame,
    Lpc,
    QuantizedParameters,
    Residual,
    SubFrame,
    Verbatim,
)
from ..errors import Verified
from ..ops import jax_env  # noqa: F401
from ..ops import fixed as ops_fixed
from ..ops import lpc as ops_lpc
from ..ops import rice as ops_rice
from ..ops.windows import get_window
from ..source import AsyncContext, FrameBuf, Source, verify_sample_range
from . import reference_encoder

import jax
import jax.numpy as jnp

# subframe type codes shared with the host packer
T_CONSTANT, T_VERBATIM, T_FIXED, T_LPC = 0, 1, 2, 3

# stereo candidate indices and assignment tables
_L, _R, _M, _S = 0, 1, 2, 3
_SLOT0 = np.array([_L, _L, _S, _M], dtype=np.int32)  # per assignment code
_SLOT1 = np.array([_R, _S, _R, _S], dtype=np.int32)
_ASSIGN_TAGS = np.array([1, 8, 9, 10], dtype=np.int32)  # FLAC header tags
# assignment code -> ChannelAssignment (immutable; shared by the packers)
_CH_INFO_BY_CODE = [
    ChannelAssignment.independent(2),
    ChannelAssignment.left_side(),
    ChannelAssignment.right_side(),
    ChannelAssignment.mid_side(),
]


class DeviceEncoded(NamedTuple):
    """Per-(block, stored-channel) encoding decisions from the device."""

    assign: jnp.ndarray        # (B,) int32 assignment code (stereo) or 0
    sf_type: jnp.ndarray       # (B, C) int32 subframe type code
    order: jnp.ndarray         # (B, C) int32 predictor order
    qcoefs: jnp.ndarray        # (B, C, MAX_LPC_ORDER) int32
    shift: jnp.ndarray         # (B, C) int32
    rice_order: jnp.ndarray    # (B, C) int32 partition order
    rice_params: jnp.ndarray   # (B, C, max_parts) int32
    errors: jnp.ndarray        # (B, C, T) int16 chosen-predictor residual
    fits16: jnp.ndarray        # (B, C) bool — errors fit int16 (else host
                               #   recomputes that channel exactly)
    sf_bits: jnp.ndarray       # (B, C) int64 exact subframe bit counts
    # NOTE: stored-channel signals are NOT shipped back — the host already
    # holds the input blocks and recomputes M/S + slot gathers in numpy,
    # halving device->host traffic.


class DeviceDecisions(NamedTuple):
    """Decisions-only device outputs (packer="native2", the default).

    Per-sample residuals never leave the chip: the C++ packer recomputes
    the chosen predictor's residual from the raw blocks the host already
    holds (native packer.cpp:flacenc_pack_frames_recompute). Download is
    ~200 bytes/frame instead of ~2 bytes/sample.

    On the wire these fields travel COALESCED into one (B, F) int32 array
    (`coalesce_decisions`/`split_decisions`): one device->host transfer
    per batch instead of eight."""

    assign: jnp.ndarray        # (B,) int32 assignment code (stereo) or 0
    sf_type: jnp.ndarray       # (B, C) int32 subframe type code
    order: jnp.ndarray         # (B, C) int32 predictor order
    qcoefs: jnp.ndarray        # (B, C, MAX_LPC_ORDER) int32
    shift: jnp.ndarray         # (B, C) int32
    rice_order: jnp.ndarray    # (B, C) int32 partition order
    rice_params: jnp.ndarray   # (B, C, max_parts) int32
    sf_bits: jnp.ndarray       # (B, C) int64 exact subframe bit counts


# fixed column groups of the coalesced decisions row, before the variable
# qcoefs (C*24) + rice_params (C*P) tail: assign, then 5 per-channel cols
_WIRE_FIXED_COLS = 5


def coalesce_decisions(dec: DeviceDecisions) -> jnp.ndarray:
    """Flatten DeviceDecisions into ONE (B, F) int32 array (device side).

    sf_bits fits int32 exactly: a chosen subframe never exceeds the
    verbatim fallback, 8 + 32767*25 bits < 2^20 (coding.rs:403-417)."""
    B = dec.assign.shape[0]
    cols = [
        dec.assign[:, None],
        dec.sf_type,
        dec.order,
        dec.shift,
        dec.rice_order,
        dec.sf_bits.astype(jnp.int32),
        dec.qcoefs.reshape(B, -1),
        dec.rice_params.reshape(B, -1),
    ]
    return jnp.concatenate([c.astype(jnp.int32) for c in cols], axis=1)


def coalesce_encoded_small(enc: DeviceEncoded) -> jnp.ndarray:
    """All DeviceEncoded fields EXCEPT the big errors tensor as one int32
    buffer: the decisions layout plus a trailing fits16 column group. Two
    fetched buffers per batch (small + errors) instead of ten."""
    small = coalesce_decisions(DeviceDecisions(
        assign=enc.assign, sf_type=enc.sf_type, order=enc.order,
        qcoefs=enc.qcoefs, shift=enc.shift, rice_order=enc.rice_order,
        rice_params=enc.rice_params, sf_bits=enc.sf_bits,
    ))
    return jnp.concatenate([small, enc.fits16.astype(jnp.int32)], axis=1)


def split_encoded(wire: np.ndarray, errors: np.ndarray,
                  nchannels: int) -> DeviceEncoded:
    """Host-side inverse of the (coalesce_encoded_small, errors) pair."""
    C = nchannels
    dec = split_decisions(wire[:, :-C], C)
    return DeviceEncoded(
        assign=dec.assign, sf_type=dec.sf_type, order=dec.order,
        qcoefs=dec.qcoefs, shift=dec.shift, rice_order=dec.rice_order,
        rice_params=dec.rice_params, sf_bits=dec.sf_bits,
        errors=np.asarray(errors),
        fits16=np.ascontiguousarray(wire[:, -C:]).astype(bool),
    )


def split_decisions(arr: np.ndarray, nchannels: int) -> DeviceDecisions:
    """Host-side inverse of `coalesce_decisions` (numpy views, no copies)."""
    B, F = arr.shape
    C = nchannels
    q = constants.qlpc.MAX_ORDER
    P = (F - 1 - C * (_WIRE_FIXED_COLS + q)) // C
    if P < 1 or F != 1 + C * (_WIRE_FIXED_COLS + q + P):
        # enforced with a real exception (not an assert, which `python -O`
        # compiles out): a nchannels/P drift between coalesce and split
        # would otherwise silently mis-split into garbage decisions
        raise ValueError(
            f"coalesced decisions width {F} is not 1 + {C} * "
            f"({_WIRE_FIXED_COLS} + {q} + P) for any partition count P >= 1"
        )
    o = 1
    fields = []
    for width in (C, C, C, C, C):
        fields.append(arr[:, o:o + width])
        o += width
    sf_type, order, shift, rice_order, sf_bits = fields
    qcoefs = arr[:, o:o + C * q].reshape(B, C, q)
    o += C * q
    rice_params = arr[:, o:].reshape(B, C, P)
    return DeviceDecisions(
        assign=np.ascontiguousarray(arr[:, 0]),
        sf_type=np.ascontiguousarray(sf_type),
        order=np.ascontiguousarray(order),
        qcoefs=np.ascontiguousarray(qcoefs),
        shift=np.ascontiguousarray(shift),
        rice_order=np.ascontiguousarray(rice_order),
        rice_params=np.ascontiguousarray(rice_params),
        sf_bits=np.ascontiguousarray(sf_bits).astype(np.int64),
    )


def _subframe_candidates(cfg, sig, bps_k, block_size, window, ext_qlpc=None,
                         ext_fixed=None):
    """Evaluate all predictor candidates for candidate channels.

    sig: (B, K, T) int32; bps_k: (K,) static bits-per-sample per candidate.
    `ext_fixed` (strict mode, ApproxEnt): host-computed (order, est_bits)
    from the native sequential-f32 entropy selector (packer.cpp
    flacenc_strict_fixed_order), replacing the device estimate whose XLA
    f32 accumulation order may differ from the reference stable build.
    Returns per-(B,K) selection arrays (see body).
    """
    sub = cfg.subframe_coding
    B, K, T = sig.shape
    bps_v = jnp.asarray(bps_k, dtype=jnp.int64)[None, :]  # (1, K)
    max_p = sub.prc.max_parameter
    too_short = T < constants.MIN_BLOCK_SIZE_FOR_PREDICTION

    is_const = jnp.all(sig == sig[..., :1], axis=-1)  # (B, K)
    verbatim_bits = 8 + T * bps_v  # (1, K) i64

    finest = ops_rice.finest_partition_order(T, constants.rice.MIN_PARTITION_SIZE)
    max_parts = 1 << finest

    zero_i = jnp.zeros((B, K), jnp.int32)
    zero_b = jnp.zeros((B, K), bool)
    zero_parts = jnp.zeros((B, K, max_parts), jnp.int32)
    big = jnp.int64(1) << 62

    # ---- fixed LPC (coding.rs:298-331) ----
    if sub.use_fixed and not too_short:
        errs = ops_fixed.fixed_lpc_errors(sig)  # (B, K, 5, T)
        n_orders = sub.fixed.max_order + 1
        order_sel = sub.fixed.order_sel
        if order_sel.type == "ApproxEnt":
            if ext_fixed is not None:
                fx_order, fx_est = ext_fixed  # (B, K) i32 / i64 host-strict
            else:
                ests = []
                for o in range(n_orders):
                    w = jnp.full((B, K), o, jnp.int32)
                    est = ops_fixed.estimate_entropy(
                        errs[:, :, o, :], w, order_sel.partitions, T
                    )
                    ests.append(est + bps_v * o)
                est_bits = jnp.stack(ests, axis=-1)  # (B, K, n_orders)
                fx_order = jnp.argmin(est_bits, axis=-1).astype(jnp.int32)  # low order wins ties
                fx_est = jnp.min(est_bits, axis=-1)
            fx_err = jnp.take_along_axis(
                errs, fx_order[..., None, None], axis=2
            )[:, :, 0, :]
            fx_rice = ops_rice.find_partitioned_rice_parameters(
                fx_err, fx_order, T, max_p
            )
        else:  # BitCount
            per_order = [
                ops_rice.find_partitioned_rice_parameters(
                    errs[:, :, o, :], jnp.full((B, K), o, jnp.int32), T, max_p
                )
                for o in range(n_orders)
            ]
            bits_o = jnp.stack(
                [bps_v * o + r.code_bits for o, r in enumerate(per_order)], axis=-1
            )
            fx_order = jnp.argmin(bits_o, axis=-1).astype(jnp.int32)
            fx_est = jnp.min(bits_o, axis=-1)
            fx_err = jnp.take_along_axis(errs, fx_order[..., None, None], 2)[:, :, 0, :]

            def sel(field):
                stacked = jnp.stack([getattr(r, field) for r in per_order], axis=-1)
                return jnp.take_along_axis(stacked, fx_order[..., None], -1)[..., 0]

            params_sel = jnp.take_along_axis(
                jnp.stack([r.params for r in per_order], axis=2),
                fx_order[..., None, None],
                axis=2,
            )[:, :, 0, :]
            fx_rice = ops_rice.RiceSearchResult(
                sel("partition_order"), params_sel, sel("code_bits"), sel("use_rice2")
            )
        fx_res_bits = ops_rice.residual_count_bits(fx_rice)
        fx_bits = 8 + bps_v * fx_order + fx_res_bits  # exact subframe bits
        fx_some = fx_est < verbatim_bits
    else:
        fx_order, fx_bits, fx_some = zero_i, jnp.broadcast_to(big, (B, K)), zero_b
        fx_err = jnp.zeros((B, K, T), jnp.int32)
        fx_rice = ops_rice.RiceSearchResult(zero_i, zero_parts, jnp.zeros((B, K), jnp.int64), zero_b)

    # ---- QLPC (coding.rs:360-381) ----
    if sub.use_lpc and not too_short:
        if ext_qlpc is not None:
            # strict mode: quantized parameters were computed host-side with
            # exact stable-reference float semantics (native strict_qlpc)
            qcoefs, q_order, q_shift = ext_qlpc
            lpc_err = ops_lpc.compute_error(
                qcoefs, q_order, q_shift, sig,
                max_taps=sub.qlpc.lpc_order,
            )
            lpc_rice = ops_rice.find_partitioned_rice_parameters(
                lpc_err, q_order, T, max_p
            )
            lpc_bits = (
                8
                + bps_v * q_order.astype(jnp.int64)
                + 4
                + 5
                + sub.qlpc.quant_precision * q_order.astype(jnp.int64)
                + ops_rice.residual_count_bits(lpc_rice)
            )
            skip_estimation = True
        else:
            skip_estimation = False
        win = None
        if not skip_estimation:
            win = ops_lpc.apply_window(sig, window)
        # estimation method dispatch (coding.rs:333-351)
        if skip_estimation:
            pass
        elif sub.qlpc.use_direct_mse:
            if sub.qlpc.mae_optimization_steps > 0:
                coefs = ops_lpc.lpc_irls_mae(
                    sig, win, sub.qlpc.lpc_order, sub.qlpc.mae_optimization_steps
                )
            else:
                coefs = ops_lpc.lpc_direct_mse(win, sub.qlpc.lpc_order)
        else:
            corr = ops_lpc.auto_correlation(win, sub.qlpc.lpc_order)
            coefs = ops_lpc.levinson(corr, sub.qlpc.lpc_order)
        if not skip_estimation:
            qcoefs, q_order, q_shift = ops_lpc.quantize_parameters(
                coefs, sub.qlpc.quant_precision
            )
            lpc_err = ops_lpc.compute_error(
                qcoefs, q_order, q_shift, sig,
                max_taps=sub.qlpc.lpc_order,
            )
            lpc_rice = ops_rice.find_partitioned_rice_parameters(
                lpc_err, q_order, T, max_p
            )
            lpc_bits = (
                8
                + bps_v * q_order.astype(jnp.int64)
                + 4
                + 5
                + sub.qlpc.quant_precision * q_order.astype(jnp.int64)
                + ops_rice.residual_count_bits(lpc_rice)
            )
    else:
        qcoefs = jnp.zeros((B, K, ops_lpc.MAX_LPC_ORDER), jnp.int32)
        q_order, q_shift = zero_i, zero_i
        lpc_err = jnp.zeros((B, K, T), jnp.int32)
        lpc_rice = ops_rice.RiceSearchResult(zero_i, zero_parts, jnp.zeros((B, K), jnp.int64), zero_b)
        lpc_bits = jnp.broadcast_to(big, (B, K))

    # ---- selection (coding.rs:384-418) ----
    baseline = jnp.where(fx_some, jnp.minimum(verbatim_bits, fx_bits), verbatim_bits)
    lpc_some = (sub.use_lpc and not too_short) & (lpc_bits < baseline)
    pred_some = lpc_some | fx_some
    pred_bits = jnp.where(lpc_some, lpc_bits, fx_bits)
    pred_type = jnp.where(lpc_some, T_LPC, T_FIXED)
    use_pred = pred_some & (pred_bits < verbatim_bits)

    sf_type = jnp.where(use_pred, pred_type, T_VERBATIM).astype(jnp.int32)
    sf_bits = jnp.where(use_pred, pred_bits, verbatim_bits)
    if sub.use_constant:
        sf_type = jnp.where(is_const, T_CONSTANT, sf_type)
        sf_bits = jnp.where(is_const, 8 + bps_v, sf_bits)

    is_lpc = sf_type == T_LPC
    order = jnp.where(is_lpc, q_order, jnp.where(sf_type == T_FIXED, fx_order, 0))
    errors = jnp.where(is_lpc[..., None], lpc_err, fx_err)
    rice_order = jnp.where(is_lpc, lpc_rice.partition_order, fx_rice.partition_order)
    rice_params = jnp.where(is_lpc[..., None], lpc_rice.params, fx_rice.params)
    # residuals of selected predictors almost always fit i16; ship them
    # half-width and let the host recompute the rare overflowing channel
    # exactly (device->host bandwidth is the throughput ceiling)
    fits16 = jnp.all(
        (errors >= -32768) & (errors <= 32767), axis=-1
    )
    return {
        "sf_type": sf_type,
        "sf_bits": sf_bits,
        "order": order.astype(jnp.int32),
        "qcoefs": qcoefs,
        "shift": q_shift,
        "rice_order": rice_order,
        "rice_params": rice_params,
        "errors": errors.astype(jnp.int16),
        "fits16": fits16,
    }


def build_encoder_fn(
    cfg: config_mod.Encoder,
    nchannels: int,
    bps: int,
    block_size: int,
    strict_lpc: bool = False,
    decisions_only: bool = False,
    packed_wire: Optional[Tuple[int, int]] = None,
    wire_encoded: bool = False,
    grouped: int = 0,
):
    """Builds the jitted device program for one (config, C, bps, T) combo.

    With `decisions_only=True` (packer="native2") per-sample residuals are
    never shipped: the program returns the decisions COALESCED into one
    (B, F) int32 buffer (see `coalesce_decisions` — one buffer = one
    device->host round trip) and the C++ packer recomputes residuals
    host-side from the raw blocks.

    With `packed_wire=(order, width)` the program takes the adaptive
    delta wire format (ops/upack.py: packed words + first samples)
    instead of raw PCM and reconstructs the int32 blocks on device —
    same outputs bit for bit, `width`/16 of the raw host->device bytes.
    """
    window = get_window(cfg.subframe_coding.qlpc.window, block_size)
    stereo = nchannels == 2

    def encode_batch(blocks: jnp.ndarray, *ext) -> DeviceEncoded:
        if packed_wire is not None:
            from ..ops import upack

            if packed_wire[0] == "r":
                _, order, p, _wu = packed_wire
                lo, unary, firsts = blocks, ext[0], ext[1]
                ext = ext[2:]
                blocks = upack.unpack_rice(
                    lo, unary, firsts, block_size, order, p
                )
            elif packed_wire[0] == "m":
                _, om, pm, wum, os2, ps, wus = packed_wire
                lo, unary, firsts = blocks, ext[0], ext[1]
                ext = ext[2:]
                blocks = upack.unpack_ms(
                    lo, unary, firsts, block_size, om, pm, wum, os2, ps,
                    wus,
                )
            elif packed_wire[0] == "d":
                _, order = packed_wire
                d, firsts = blocks, ext[0]
                ext = ext[1:]
                blocks = upack.unpack_delta(d, firsts, block_size, order)
            else:
                _, order, width = packed_wire
                words, firsts = blocks, ext[0]
                ext = ext[1:]
                blocks = upack.unpack(words, firsts, block_size, order, width)
        B, C, T = blocks.shape
        blocks = blocks.astype(jnp.int32)  # accepts int16 uploads (bps<=16)
        if stereo:
            l = blocks[:, 0, :].astype(jnp.int64)
            r = blocks[:, 1, :].astype(jnp.int64)
            mid = ((l + r) >> 1).astype(jnp.int32)
            side = (l - r).astype(jnp.int32)
            cand = jnp.stack(
                [blocks[:, 0, :], blocks[:, 1, :], mid, side], axis=1
            )  # (B, 4, T)
            bps_k = [bps, bps, bps, bps + 1]
        else:
            cand = blocks
            bps_k = [bps] * C

        ext_qlpc = ext[:3] if strict_lpc else None
        ext_fixed = ext[3:5] if strict_lpc and len(ext) == 5 else None
        res = _subframe_candidates(
            cfg, cand, bps_k, block_size, window,
            ext_qlpc=ext_qlpc, ext_fixed=ext_fixed,
        )

        if stereo:
            bits = res["sf_bits"]  # (B, 4)
            combos = [bits[:, _L] + bits[:, _R]]  # code 0: LR
            codes = [0]
            st = cfg.stereo_coding
            for flag, code, expr in (
                (st.use_leftside, 1, bits[:, _L] + bits[:, _S]),
                (st.use_rightside, 2, bits[:, _R] + bits[:, _S]),
                (st.use_midside, 3, bits[:, _M] + bits[:, _S]),
            ):
                if flag:
                    combos.append(expr)
                    codes.append(code)
            combo_bits = jnp.stack(combos, axis=-1)
            # strict `<` update loop → first minimum wins (coding.rs:515-522)
            best = jnp.argmin(combo_bits, axis=-1)
            assign = jnp.asarray(codes, jnp.int32)[best]
            s0 = jnp.asarray(_SLOT0, jnp.int32)[assign]
            s1 = jnp.asarray(_SLOT1, jnp.int32)[assign]
            slot_idx = jnp.stack([s0, s1], axis=-1)  # (B, 2)

            def gather(a):
                idx = slot_idx.reshape(slot_idx.shape + (1,) * (a.ndim - 2))
                return jnp.take_along_axis(a, idx, axis=1)

            out = {k: gather(v) for k, v in res.items()}
        else:
            assign = jnp.zeros((B,), jnp.int32)
            out = res

        if decisions_only:
            # ONE output buffer = one device->host round trip per batch
            return coalesce_decisions(DeviceDecisions(
                assign=assign,
                sf_type=out["sf_type"],
                order=out["order"],
                qcoefs=out["qcoefs"],
                shift=out["shift"],
                rice_order=out["rice_order"],
                rice_params=out["rice_params"],
                sf_bits=out["sf_bits"],
            ))

        enc = DeviceEncoded(
            assign=assign,
            sf_type=out["sf_type"],
            order=out["order"],
            qcoefs=out["qcoefs"],
            shift=out["shift"],
            rice_order=out["rice_order"],
            rice_params=out["rice_params"],
            errors=out["errors"],
            fits16=out["fits16"],
            sf_bits=out["sf_bits"],
        )
        if wire_encoded:
            # two output buffers (small decisions + errors): two transport
            # round trips per fetched batch instead of ten
            return coalesce_encoded_small(enc), enc.errors
        return enc

    if grouped:
        # grouped device roundtrip: G stacked payloads in, (G, B, F)
        # decisions out — the per-batch program is the lax.map body, so
        # XLA compiles/tiles it exactly once at the measured-good batch
        # shape instead of re-tiling a G*B flat batch
        def encode_group(*stacked):
            return jax.lax.map(
                lambda xs: encode_batch(*xs), tuple(stacked)
            )

        return jax.jit(encode_group)

    return jax.jit(encode_batch)


# ---------------------------------------------------------------------------
# Host-side frame assembly
# ---------------------------------------------------------------------------


def _quotients_remainders_batch(
    errors: np.ndarray, rice_params: np.ndarray, rice_order: np.ndarray, warmup: np.ndarray
) -> Tuple[np.ndarray, np.ndarray]:
    """Vectorized per-sample Rice split for a whole batch.

    errors (B, C, T) i32; rice_params (B, C, P) i32; rice_order (B, C);
    warmup (B, C). Returns (quotients, remainders) as (B, C, T) u32.
    """
    B, C, T = errors.shape
    v64 = np.abs(errors.astype(np.int64))
    z = ((v64 << 1) - (errors < 0)).astype(np.uint32)
    t_idx = np.arange(T, dtype=np.int64)
    nparts = (1 << rice_order.astype(np.int64))[..., None]  # (B, C, 1)
    pidx = (t_idx[None, None, :] * nparts) // T
    p_t = np.take_along_axis(rice_params, pidx, axis=2).astype(np.uint32)
    q = z >> p_t
    r = z & ((np.uint32(1) << p_t) - np.uint32(1))
    warm_mask = t_idx[None, None, :] < warmup[..., None]
    q[warm_mask] = 0
    r[warm_mask] = 0
    return q, r


def _slot_signals(blocks: np.ndarray, assign: np.ndarray, nchannels: int) -> np.ndarray:
    """Recomputes the stored-channel signals on the host.

    The device only ships decisions + residuals; L/R come straight from the
    input blocks and M/S are two vector ops (coding.rs:478-484)."""
    if nchannels != 2:
        return np.ascontiguousarray(blocks, dtype=np.int32)
    l = blocks[:, 0].astype(np.int64)
    r = blocks[:, 1].astype(np.int64)
    cand = np.stack(
        [blocks[:, 0], blocks[:, 1],
         ((l + r) >> 1).astype(np.int32), (l - r).astype(np.int32)],
        axis=1,
    )
    idx = np.stack([_SLOT0[assign], _SLOT1[assign]], axis=1)[..., None]
    return np.ascontiguousarray(np.take_along_axis(cand, idx, axis=1))


def _host_errors(enc, signal: np.ndarray, cfg) -> np.ndarray:
    """int16-shipped residuals -> int32, recomputing overflow channels.

    Channels whose residuals did not fit int16 (flagged on device) are
    recomputed exactly on the host: one batched C++ call over the
    gathered channel list (native.compute_errors — the same kernels the
    recompute packer uses), so a 24-bit corpus whose side channels
    overflow en masse stays vectorized; the scalar oracle kernels remain
    the no-native fallback."""
    errors = np.asarray(enc.errors).astype(np.int32)
    fits16 = np.asarray(enc.fits16)
    sf_type = np.asarray(enc.sf_type)
    needs_fix = (~fits16) & (sf_type >= T_FIXED)
    if not needs_fix.any():
        return errors
    from .. import native

    order = np.asarray(enc.order)
    qcoefs = np.asarray(enc.qcoefs)
    shift = np.asarray(enc.shift)
    bs, cs = np.nonzero(needs_fix)
    fixed = native.compute_errors(
        signal[bs, cs], (sf_type[bs, cs] == T_LPC).astype(np.int32),
        order[bs, cs], qcoefs[bs, cs], shift[bs, cs],
    )
    if fixed is not None:
        errors[bs, cs] = fixed
        return errors
    from ..ops import ref_np

    for b, c in zip(bs, cs):
        sig = signal[b, c]
        if sf_type[b, c] == T_FIXED:
            errors[b, c] = ref_np.fixed_lpc_errors(sig)[order[b, c]]
        else:
            errors[b, c] = ref_np.compute_error(
                qcoefs[b, c, : order[b, c]].astype(np.int16),
                int(shift[b, c]),
                sig,
            )
    return errors


def _assemble_frames(assign, nchannels, frame_numbers, sample_rate, bps,
                     block_size, data, sizes) -> List[Frame]:
    """Shared tail of the native packers: Frame objects carrying sliced
    precomputed bitstreams (datatype.rs:1036-1049).

    Every header in a batch shares its specs (only frame number and
    channel assignment vary), so the four stereo variants are built once
    and copy.copy'd per frame — the per-frame spec constructors were
    ~2/3 of this loop's host CPU at batch 256."""
    import copy

    frames: List[Frame] = []
    offset = 0
    view = memoryview(data)
    stereo = nchannels == 2
    if stereo:
        templates = [
            reference_encoder._new_frame_header(
                block_size, _CH_INFO_BY_CODE[code], sample_rate, bps
            )
            for code in range(4)
        ]
    else:
        templates = [
            reference_encoder._new_frame_header(
                block_size, ChannelAssignment.independent(nchannels),
                sample_rate, bps,
            )
        ]
    for t in templates:
        t.set_frame_number(0)  # fixed-blocking flip once, copies keep it
    codes = np.asarray(assign).tolist() if stereo else None
    nums = np.asarray(frame_numbers).tolist()
    for b, size in enumerate(np.asarray(sizes).tolist()):
        header = copy.copy(templates[codes[b]] if stereo else templates[0])
        header.frame_number = nums[b]
        frame = Frame(header, [])
        end = offset + size
        frame.precomputed_bitstream = bytes(view[offset:end])
        offset = end
        frames.append(frame)
    return frames


def pack_frames_native(
    enc, blocks, frame_numbers, cfg, nchannels, bps, sample_rate, block_size
) -> List[Frame]:
    """Packs device outputs with the C++ packer; returns `Frame` objects
    carrying precomputed bitstreams (the reference's
    ``Frame::precompute_bitstream`` fast path, datatype.rs:1036-1049)."""
    from .. import native
    from ..component.datatype import BlockSizeSpec, SampleRateSpec, SampleSizeSpec

    enc = DeviceEncoded(**jax.device_get(enc._asdict()))  # one round trip
    assign = np.asarray(enc.assign)
    B = assign.shape[0]
    stereo = nchannels == 2
    if stereo:
        ch_tag = _ASSIGN_TAGS[assign]
    else:
        ch_tag = np.full(B, nchannels - 1, dtype=np.int32)

    bs = BlockSizeSpec.from_size(block_size)
    # rate 0/None means "not provided" -> unspecified tag (from_freq(0)
    # would yield a truthy tag-12 '0 kHz' spec)
    sr = (
        SampleRateSpec.from_freq(sample_rate) if sample_rate else None
    ) or SampleRateSpec.UNSPECIFIED
    ss = SampleSizeSpec.from_bits(bps)
    signal = _slot_signals(blocks, assign, nchannels)
    errors = _host_errors(enc, signal, cfg)
    data, sizes = native.pack_frames(
        signal, errors,
        np.asarray(enc.sf_type), np.asarray(enc.order),
        np.asarray(enc.qcoefs), np.asarray(enc.shift),
        np.asarray(enc.rice_order), np.asarray(enc.rice_params),
        ch_tag, np.asarray(frame_numbers, dtype=np.int64),
        bps, cfg.subframe_coding.qlpc.quant_precision,
        (bs.tag, bs.count_extra_bits(), bs.extra or 0),
        (sr.tag, sr.count_extra_bits(), sr.extra or 0),
        ss.tag,
    )
    return _assemble_frames(
        assign, nchannels, frame_numbers, sample_rate, bps, block_size,
        data, sizes,
    )


def pack_frames_decisions(
    enc, blocks, frame_numbers, cfg, nchannels, bps, sample_rate, block_size
) -> List[Frame]:
    """Packs from device DECISIONS only (packer="native2", the default).

    The C++ packer recomputes stored channels and residuals from the raw
    input blocks (native packer.cpp), so the device download is just the
    per-channel choices — the host<->device boundary plan of SURVEY §7
    hard part #3 taken to its end point."""
    from .. import native
    from ..component.datatype import BlockSizeSpec, SampleRateSpec, SampleSizeSpec

    if not isinstance(enc, DeviceDecisions):
        # coalesced wire buffer (device or host): one fetch, then split
        enc = split_decisions(np.asarray(jax.device_get(enc)), nchannels)
    elif not isinstance(enc.assign, np.ndarray):
        enc = DeviceDecisions(**jax.device_get(enc._asdict()))
    assign = np.asarray(enc.assign)
    B = assign.shape[0]
    stereo = nchannels == 2
    if stereo:
        ch_tag = _ASSIGN_TAGS[assign]
    else:
        ch_tag = np.full(B, nchannels - 1, dtype=np.int32)

    bs = BlockSizeSpec.from_size(block_size)
    # rate 0/None means "not provided" -> unspecified tag (from_freq(0)
    # would yield a truthy tag-12 '0 kHz' spec)
    sr = (
        SampleRateSpec.from_freq(sample_rate) if sample_rate else None
    ) or SampleRateSpec.UNSPECIFIED
    ss = SampleSizeSpec.from_bits(bps)
    from ..parallel import determine_worker_count

    data, sizes = native.pack_frames_recompute(
        blocks, assign,
        np.asarray(enc.sf_type), np.asarray(enc.order),
        np.asarray(enc.qcoefs), np.asarray(enc.shift),
        np.asarray(enc.rice_order), np.asarray(enc.rice_params),
        ch_tag, np.asarray(frame_numbers, dtype=np.int64),
        bps, cfg.subframe_coding.qlpc.quant_precision,
        (bs.tag, bs.count_extra_bits(), bs.extra or 0),
        (sr.tag, sr.count_extra_bits(), sr.extra or 0),
        ss.tag,
        n_threads=determine_worker_count(cfg),
    )
    return _assemble_frames(
        assign, nchannels, frame_numbers, sample_rate, bps, block_size,
        data, sizes,
    )


def frames_from_device(
    enc, blocks, frame_numbers, cfg, nchannels, bps, sample_rate, block_size
) -> List[Frame]:
    """Builds `component.Frame` objects from device outputs (oracle packer)."""
    sub = cfg.subframe_coding
    enc = DeviceEncoded(**jax.device_get(enc._asdict()))  # one round trip
    assign = np.asarray(enc.assign)
    sf_type = np.asarray(enc.sf_type)
    order = np.asarray(enc.order)
    qcoefs = np.asarray(enc.qcoefs)
    shift = np.asarray(enc.shift)
    rice_order = np.asarray(enc.rice_order)
    rice_params = np.asarray(enc.rice_params)
    signal = _slot_signals(blocks, assign, nchannels)
    errors = _host_errors(enc, signal, cfg)
    B, C, T = signal.shape

    warmup = np.where(sf_type >= T_FIXED, order, 0)
    qarr, rarr = _quotients_remainders_batch(errors, rice_params, rice_order, warmup)

    frames = []
    stereo = nchannels == 2
    for b in range(B):
        if stereo:
            ch_info = _CH_INFO_BY_CODE[assign[b]]
        else:
            ch_info = ChannelAssignment.independent(nchannels)
        header = reference_encoder._new_frame_header(T, ch_info, sample_rate, bps)
        header.set_frame_number(int(frame_numbers[b]))
        subframes: List[SubFrame] = []
        for c in range(C):
            bps_c = bps + ch_info.bits_per_sample_offset(c)
            t = sf_type[b, c]
            sig = signal[b, c]
            if t == T_CONSTANT:
                subframes.append(Constant(T, int(sig[0]), bps_c))
            elif t == T_VERBATIM:
                subframes.append(Verbatim(sig, bps_c))
            else:
                o = int(order[b, c])
                nparts = 1 << int(rice_order[b, c])
                residual = Residual(
                    int(rice_order[b, c]), T, o,
                    rice_params[b, c, :nparts].astype(np.uint8),
                    qarr[b, c], rarr[b, c],
                )
                if t == T_FIXED:
                    subframes.append(FixedLpc(sig[:o], residual, bps_c))
                else:
                    params = QuantizedParameters(
                        qcoefs[b, c, :o].astype(np.int16), o,
                        int(shift[b, c]), sub.qlpc.quant_precision,
                    )
                    subframes.append(Lpc(sig[:o], params, residual, bps_c))
        frames.append(Frame(header, subframes))
    return frames


# ---------------------------------------------------------------------------
# Stream-level entry point
# ---------------------------------------------------------------------------

DEFAULT_BATCH = 64

# A measured raw-wire effective bandwidth above this means the link is
# not the bottleneck (PCIe-class): stay on the zero-CPU raw wire and
# don't spend compiles/CPU exploring packed formats
_FAST_LINK_MBPS = 400.0
# saturated batches between re-probes of a currently-losing wire format
_EXPLORE_EVERY = 16
# never re-probe a format predicted worse than this ratio vs the current
# one (a 100x-regime shift moves the in-use format's estimate too, so
# the ratio shrinks until probing resumes on its own)
_EXPLORE_MAX_RATIO = 3.0
# consecutive batches per probe: with homogeneous-pair gap attribution
# (drain_one only credits a gap when the drained batch AND its
# predecessor share a wire kind) a 1-batch probe would never produce a
# sample, so probes hold the kind for 2 batches and the second one reads
# clean
_PROBE_LEN = 2
# consecutive winning choose() calls before the incumbent is dethroned:
# a single lucky gap sample (a drain that landed right after the
# pipeline prefilled) used to flip the incumbent to a slower wire for
# _EXPLORE_EVERY batches at a time
_SWITCH_VOTES = 2
# an estimate is FRESH (eligible to win a switch) only if sampled within
# this many batches AND this many wall seconds: a link whose bandwidth
# shifts minute to minute makes an estimate from the previous window
# (or from before an inter-encode pause) mis-rank the wires. Stale kinds
# can only be reached through a probe, which refreshes them first.
_FRESH_AGE = 32
_FRESH_SECONDS = 15.0
# batches between full try_pack scans when a cached rice plan keeps
# packing cleanly (see BatchPipeline._try_pack_cached)
_PLAN_RESCAN_EVERY = 16
# grouped device roundtrip: a remote transport that serializes transfers
# AND charges a fixed round trip per transfer regardless of payload size
# makes per-batch fetches latency-bound. Stacking G batches' wire payloads host-side
# (a memcpy), uploading ONCE, running ONE lax.map-over-G program (the
# per-batch program as the scan body, so the well-tiled 256-batch
# kernels are reused — a 4x bigger flat batch measured strictly WORSE),
# and fetching ONE (G, B, F) decisions buffer divides the per-RPC cost
# by G in both directions. On PCIe-class links a transfer is
# sub-millisecond and grouping would only delay assembly, so auto mode
# engages ONLY once the measured fetch-only wall EWMA exceeds
# _GROUP_FETCH_MIN_S (and the grouped program has background-compiled —
# an inline remote compile would stall the stream). FLACENC_FETCH_GROUP
# pins the group size (1 = never group).
_FETCH_GROUP_AUTO = 4
_GROUP_FETCH_MIN_S = 0.015
# process-wide registry of warmed grouped programs (compile + one run),
# mirroring _WARMED_WIRES: a new pipeline must not re-pay the compile
# fallback for a grouped program an earlier encode already warmed
_WARMED_GROUPS: set = set()
# last measured fetch-wall EWMA in this process (None until a fetch
# completes anywhere): seeds new pipelines' auto-group gate so short
# streams on slow links group from their first batches (a single
# stream's submission often outruns its own first fetch). GIL-atomic
# float store; staleness self-corrects via the grouped-path feedback.
_LAST_FETCH_EWMA: Optional[float] = None
# outstanding background group-warm futures: a bench/caller can block on
# these after a warm-up encode so timed runs group from their first
# batches instead of racing the compile (see wait_group_warms)
_GROUP_WARM_FUTURES: list = []


def _drain_warm_futures(pending, timeout: Optional[float]) -> None:
    """Wait on each warm future under ONE shared deadline, continuing
    past failures: a failed/slow background compile means the pipeline
    falls back (per-batch path / raw wire) — a valid, measurable state —
    so one bad warm must not abandon the remaining waits or propagate
    into the caller and skip its OTHER warm barrier (review r5)."""
    import time as _time

    deadline = None if timeout is None else _time.monotonic() + timeout
    for fut in pending:
        try:
            left = (None if deadline is None
                    else max(0.0, deadline - _time.monotonic()))
            fut.result(timeout=left)
        except Exception:  # noqa: BLE001 - compile error or timeout
            continue


def wait_group_warms(timeout: Optional[float] = None) -> None:
    """Block until every outstanding grouped-program background compile
    has settled (no-op when none are pending; failures/timeouts are
    swallowed — see _drain_warm_futures). A warm-up encode only STARTS
    these compiles; short timed encodes right after it would otherwise
    run per-batch while the compile races them."""
    global _GROUP_WARM_FUTURES
    pending, _GROUP_WARM_FUTURES = _GROUP_WARM_FUTURES, []
    _drain_warm_futures(pending, timeout)


# outstanding background per-wire compile futures (same contract as
# _GROUP_WARM_FUTURES, for the wire-variant programs `_start_warm`
# kicks): measurement harnesses block on these after a warm-up encode so
# a short timed run's racer can actually probe the packed wires instead
# of finding them compile-pending for most of its batches
_WIRE_WARM_FUTURES: list = []


def wait_wire_warms(timeout: Optional[float] = None) -> None:
    """Block until every outstanding wire-variant background compile has
    settled (no-op when none are pending; failures/timeouts are
    swallowed — see _drain_warm_futures). Companion to
    `wait_group_warms`; see _WIRE_WARM_FUTURES."""
    global _WIRE_WARM_FUTURES
    pending, _WIRE_WARM_FUTURES = _WIRE_WARM_FUTURES, []
    _drain_warm_futures(pending, timeout)


def wait_all_warms(timeout: Optional[float] = None) -> None:
    """One warm barrier for measurement harnesses: settle the wire-
    variant compiles AND the grouped-program compiles under a shared
    deadline (each half gets whatever remains). Never raises — a failed
    warm degrades the measurement (fallback wire / per-batch path), it
    must not kill the harness."""
    import time as _time

    t0 = _time.monotonic()
    wait_wire_warms(timeout)
    left = None if timeout is None else max(
        0.0, timeout - (_time.monotonic() - t0))
    wait_group_warms(left)


class LinkEstimator:
    """Per-wire-format batch-time racer.

    Thresholding ONE bandwidth estimate against fixed MB/s bands fails
    when the wires do not share a bandwidth: a compressing transport
    moves raw PCM of tonal material faster than its nominal bytes while
    the entropy-dense rice wire moves at nominal speed, and the packs'
    host CPU cost rivals the link gap on small hosts. Which wire is
    fastest then flips with BOTH the link window and the corpus — so
    measure each wire's actual steady-state batch completion gap and
    race them:

    - `update(nbytes, seconds, kind)` feeds the drained batch's gap into
      the kind's geometric EWMA (gaps at full pipeline depth measure the
      bottleneck stage — link time AND the wire's own CPU cost included,
      whichever binds; log-space averaging follows decade-scale link
      swings in 2-3 samples). The caller only feeds gaps
      whose drained batch shares its wire kind with the batch drained
      just before it (homogeneous pairs): in a mixed in-flight window
      the completion gap measures the MIX's bottleneck, and attributing
      it to the drained batch's kind measured as a 1.35x end-to-end loss
      (lucky samples kept flipping the incumbent to slower wires).
    - `choose(kinds, current)` returns the kind with the smallest
      predicted gap among kinds with FRESH estimates (sampled within
      `_FRESH_AGE` batches and `_FRESH_SECONDS` wall seconds — a stale
      estimate is from a different link window and routinely mis-ranks
      the wires), with a 10% preference for the incumbent plus a
      `_SWITCH_VOTES`-decision debounce (hysteresis against
      flip-thrash). Stale kinds are only reachable through a
      `_PROBE_LEN`-batch re-probe (2 consecutive batches so the
      homogeneous-pair rule yields exactly one clean sample), gated by
      a BYTES-based prediction at the incumbent's current effective
      speed — `nbytes[k] / mbps(current)` — because wire bytes are a
      stable content property while a stale seconds estimate is not.
      Cold start measures raw first: packed kinds are only explored
      once a measured raw gap shows the link is slower than
      `_FAST_LINK_MBPS` (on PCIe-class links raw is optimal and
      exploration would only burn compiles).

    Wire kinds: "raw" (int16/int32 PCM), "d" (delta16 — near-zero CPU,
    transport-compressible), "pack" (the dense "w"/"r" formats of
    ops/upack.try_pack). Output bytes NEVER depend on the wire.
    """

    def __init__(self) -> None:
        self.secs: dict = {}    # kind -> EWMA steady-state seconds/batch
        self.nbytes: dict = {}  # kind -> EWMA wire bytes/batch
        self.age: dict = {}     # kind -> choose() calls since sampled
        self.t_sample: dict = {}  # kind -> wall time of last sample
        self.mbps: Optional[float] = None  # latest effective MB/s (stats)
        self._probe: Optional[tuple] = None  # (kind, batches remaining)
        self._vote: Optional[tuple] = None   # (challenger kind, wins)

    def update(self, nbytes: int, seconds: float, kind: str = "raw") -> None:
        if seconds <= 0 or nbytes <= 0:
            return
        import time as _time

        self.mbps = max(nbytes / seconds / 1e6, 1e-3)
        prev = self.secs.get(kind)
        # geometric EWMA, but adopt IMPROVEMENTS faster (cap at 2x the
        # new sample): gap noise is one-sided — stalls inflate a gap,
        # nothing deflates it below the wire's true cost — so a much
        # faster sample is direct evidence, a much slower one may be a
        # transient stall
        self.secs[kind] = (
            seconds if prev is None
            else min(float((prev * seconds) ** 0.5), 2.0 * seconds)
        )
        prevb = self.nbytes.get(kind)
        self.nbytes[kind] = (
            nbytes if prevb is None else float((prevb * nbytes) ** 0.5)
        )
        self.age[kind] = 0
        self.t_sample[kind] = _time.perf_counter()

    def _link_is_fast(self) -> bool:
        raw_s, raw_b = self.secs.get("raw"), self.nbytes.get("raw")
        return raw_s is not None and raw_b is not None and (
            raw_b / raw_s / 1e6 > _FAST_LINK_MBPS
        )

    def _is_fresh(self, kind: str) -> bool:
        import time as _time

        t = self.t_sample.get(kind)
        return (
            kind in self.secs
            and self.age.get(kind, _FRESH_AGE + 1) <= _FRESH_AGE
            and t is not None
            and _time.perf_counter() - t <= _FRESH_SECONDS
        )

    def initial_kind(self, kinds) -> str:
        """Best starting incumbent for a NEW pipeline: raw when unproven
        or fast-link, else the smallest-bytes measured kind (bytes are
        the window-invariant ranking; a new encode often starts in a
        different bandwidth window than the last one ended in)."""
        if "raw" not in self.secs or self._link_is_fast():
            return "raw"
        known = [k for k in kinds if k in self.nbytes]
        if not known:
            return "raw"
        return min(known, key=lambda k: self.nbytes[k])

    def choose(self, kinds, current: str) -> str:
        # ages tick per DECISION (≈ per batch): the homogeneous-pair rule
        # makes update() calls sparse during wire churn, and an age that
        # only ticks on updates can freeze, never triggering re-probes
        for k in kinds:
            self.age[k] = self.age.get(k, _FRESH_AGE + 1) + 1
        # finish an in-progress probe: the 2nd consecutive batch is the
        # one whose drain gap gets attributed (homogeneous-pair rule)
        if self._probe is not None:
            k, n = self._probe
            self._probe = None
            if n > 0 and k in kinds:
                self._probe = (k, n - 1)
                return k
        known = {k: self.secs[k] for k in kinds if k in self.secs}
        if "raw" not in known:
            return "raw"  # cold start: measure the zero-CPU wire first
        if len(known) < len(kinds):
            # unexplored kinds: probe them (once each) unless the raw
            # gap already proves the link is not the bottleneck
            if self._link_is_fast():
                return "raw"
            for k in kinds:
                if k not in known:
                    self._probe = (k, _PROBE_LEN - 1)
                    return k
        cur = known.get(current, float("inf"))
        cur_bytes = self.nbytes.get(current)
        mbps_cur = (
            cur_bytes / cur / 1e6
            if cur_bytes and cur not in (0.0, float("inf")) else self.mbps
        )
        # stale re-probe: estimates decay in relevance as the link
        # swings; refresh a losing kind occasionally — gated by the
        # BYTES-predicted cost at the incumbent's current effective
        # speed (clearly-losing kinds get probed half as often)
        for k in kinds:
            if k == current or self.age.get(k, 0) < _EXPLORE_EVERY:
                continue
            pred = (
                self.nbytes[k] / (mbps_cur * 1e6)
                if mbps_cur and k in self.nbytes else known.get(k)
            )
            if pred is None or pred > cur * _EXPLORE_MAX_RATIO:
                continue
            if pred > cur * 1.2 and self.age.get(k, 0) < 2 * _EXPLORE_EVERY:
                continue
            self.age[k] = 0  # pay the probe now, not again next batch
            self._probe = (k, _PROBE_LEN - 1)
            return k
        # only FRESH estimates may win a switch: a stale-fast estimate
        # from a previous bandwidth window must not capture the choice
        fresh = {k: v for k, v in known.items() if self._is_fresh(k)}
        if current not in fresh:
            # no live signal on the incumbent yet (e.g. new pipeline):
            # keep it if its estimate exists, else fall back to the
            # smallest-bytes kind
            if current in known:
                return current
            return self.initial_kind(kinds)
        best = min(fresh, key=fresh.get)
        if best != current and fresh[best] < cur * 0.9:
            # debounce: a challenger must hold its predicted win across
            # _SWITCH_VOTES consecutive decisions before taking over
            k, n = (self._vote if self._vote and self._vote[0] == best
                    else (best, 0))
            n += 1
            if n >= _SWITCH_VOTES:
                self._vote = None
                return best
            self._vote = (k, n)
            return current
        self._vote = None
        return current


# process-wide estimators, keyed by payload-shape bucket: the link
# identity doesn't change within a process, but its SPEED does — the
# racer keeps learning across encodes of the same shape. Bucketing by
# log2(samples/batch) keeps a batch-64 stream and a batch-256 corpus in
# the SAME process from cross-polluting each other's gap estimates
# (VERDICT r3 weak #6): a gap is latency + payload/bandwidth + wire CPU,
# so batches 4x apart in size have incomparable gaps.
_LINK_ESTS: dict = {}


def _shape_bucket(samples_per_batch: int) -> int:
    return max(samples_per_batch, 1).bit_length()


def _link_est_for(bucket: int) -> LinkEstimator:
    est = _LINK_ESTS.get(bucket)
    if est is None:
        est = _LINK_ESTS[bucket] = LinkEstimator()
    return est


def _bucket_pad(chunk: np.ndarray, batch_size: int) -> np.ndarray:
    """Pad partial batches to the full batch size: exactly ONE device
    program exists per (config, C, bps, T, batch). Padded blocks cost at
    most one batch of device time per encode — far cheaper than compiling
    per-shape programs (compilation dominates on remote-compile setups)."""
    n = chunk.shape[0]
    if n == batch_size:
        return chunk
    pad = np.zeros((batch_size - n,) + chunk.shape[1:], chunk.dtype)
    return np.concatenate([chunk, pad])


# process-wide registry of (program, shapes, sharding) combinations that
# have completed a full compile + first execution. A BatchPipeline is
# per-encode, but the jit cache (`_cached_encoder_fn`) is per-process:
# without this registry every NEW pipeline re-"warmed" wires whose
# programs were already hot, shipping several raw-fallback batches per
# encode (measured: 4 of 26 batches on the bench trials — at slow-link
# prices, the single largest racer overhead).
_WARMED_WIRES: set = set()


@functools.lru_cache(maxsize=64)
def _cached_encoder_fn(cfg_key, nchannels, bps, block_size,
                       strict_lpc=False, decisions_only=False,
                       packed_wire=None, wire_encoded=False, grouped=0):
    cfg = config_mod.Encoder.from_toml(cfg_key)
    return build_encoder_fn(
        cfg, nchannels, bps, block_size, strict_lpc, decisions_only,
        packed_wire, wire_encoded, grouped,
    )


def _candidate_signals(chunk: np.ndarray, nchannels: int) -> np.ndarray:
    """Host-side candidate channels (L, R, M, S for stereo)."""
    if nchannels != 2:
        return chunk
    l = chunk[:, 0].astype(np.int64)
    r = chunk[:, 1].astype(np.int64)
    return np.stack(
        [chunk[:, 0], chunk[:, 1],
         ((l + r) >> 1).astype(np.int32), (l - r).astype(np.int32)],
        axis=1,
    )


def _strict_ext_arrays(chunk: np.ndarray, cfg, nchannels: int, bps: int, window):
    """Host-computed strict-mode arrays for every candidate channel.

    QLPC params come from the native sequential-FMA estimator; for
    ApproxEnt configs the fixed-LPC order selection additionally comes from
    the native sequential-f32 entropy (both matching the reference STABLE
    build's float semantics exactly)."""
    from .. import native

    if not native.available():
        raise RuntimeError(
            "strict mode requires the native library "
            f"(build failed: {native._load_error!r}); "
            "run `python flacenc_tpu/native/build.py`"
        )
    sub = cfg.subframe_coding
    cand = _candidate_signals(chunk, nchannels)
    B, K, T = cand.shape
    flat = np.ascontiguousarray(cand.reshape(B * K, T), dtype=np.int32)
    q, o, sh = native.strict_qlpc(
        flat, window, sub.qlpc.lpc_order, sub.qlpc.quant_precision,
    )
    ext = [
        q.reshape(B, K, ops_lpc.MAX_LPC_ORDER),
        o.reshape(B, K).astype(np.int32),
        sh.reshape(B, K).astype(np.int32),
    ]
    if sub.use_fixed and sub.fixed.order_sel.type == "ApproxEnt":
        if nchannels == 2:
            bps_k = np.array([bps, bps, bps, bps + 1], np.int32)
        else:
            bps_k = np.full(K, bps, np.int32)
        bps_flat = np.broadcast_to(bps_k, (B, K)).reshape(B * K).copy()
        fo, fe = native.strict_fixed_order(
            flat, bps_flat, sub.fixed.max_order,
            sub.fixed.order_sel.partitions,
        )
        ext += [fo.reshape(B, K).astype(np.int32), fe.reshape(B, K)]
    return tuple(ext)


class BatchResult(NamedTuple):
    """One drained batch: assembled frames plus caller bookkeeping."""

    frames: List[Frame]   # only the valid (non-padding) frames
    nums: np.ndarray      # frame numbers passed to submit
    cookie: object        # caller-provided routing cookie
    device_wait_s: float  # main thread blocked on the batch future
    pack_s: float         # io-thread frame assembly time (overlaps
    #                       other batches' link waits; host-CPU cost,
    #                       NOT main-thread serial time)


class BatchPipeline:
    """Shared upload/dispatch/fetch machinery for the stream and corpus
    encoders (single source of truth — VERDICT r2 review finding).

    Bounded-depth in-flight queue; upload + device dispatch + decisions
    download run on a background thread (GIL released during transfers and
    the ctypes pack call); optional mesh sharding of the batch axis;
    strict-mode host arrays; per-batch sample-range validation.
    """

    def __init__(self, cfg, nch: int, bps: int, block_size: int,
                 batch_size: int, packer: str = "auto",
                 strict_lpc: bool = False, mesh="auto",
                 upload_pack="env"):
        import concurrent.futures
        import os

        if packer == "auto":
            from .. import native

            # decisions-only download + C++ residual recompute ("native2")
            # wins on every link: ~200 B/frame instead of ~2 B/sample
            packer = "native2" if native.available() else "python"
        self.cfg = cfg
        self.nch, self.bps = nch, bps
        self.block_size, self.batch_size = block_size, batch_size
        self.packer = packer
        self.strict_lpc = strict_lpc
        self.assemble = {
            "native2": pack_frames_decisions,
            "native": pack_frames_native,
            "python": frames_from_device,
        }[packer]
        self.strict_window = (
            get_window(cfg.subframe_coding.qlpc.window, block_size)
            if strict_lpc else None
        )
        self._fns = {}  # wire format -> jitted program, built lazily
        explicit_pack = upload_pack is True
        if upload_pack == "env":
            env = os.environ.get("FLACENC_PACKED_UPLOAD", "")
            upload_pack = {"1": True, "d": "delta", "auto": "auto"}.get(
                env, False)
        # packed upload wire formats (ops/upack.py): fewer or
        # more-compressible host->device bytes, always exact. Every
        # backend is host-local, where raw PCM is optimal (transfers are
        # plain copies), so raw is the default; "auto" RACES the wire
        # kinds on their measured steady-state batch gaps
        # (`LinkEstimator`), flipping between batches, and runs only when
        # asked for (upload_pack="auto" or FLACENC_PACKED_UPLOAD=auto).
        # Each wire the stream visits compiles one program variant.
        self.upload_mode = "off"
        eligible = False
        if upload_pack:
            from ..ops import upack as _upack

            # dense/rice wires cover hi-res too (bps <= 24, raw int32
            # otherwise); the delta16 wire's mod-2^16 reconstruction only
            # holds for bps <= 16 (_delta_eligible below)
            eligible = (bps <= _upack.MAX_PACK_BPS
                        and block_size % _upack.GROUP == 0)
            if explicit_pack and not eligible:
                raise ValueError(
                    "upload_pack=True requires bits_per_sample <= "
                    f"{_upack.MAX_PACK_BPS} and a "
                    f"block size divisible by {_upack.GROUP} "
                    f"(got bps={bps}, block_size={block_size})"
                )
            if upload_pack == "auto":
                from .. import native

                # adapt only on the default decisions path: residual-
                # shipping packers are already download-heavy, and their
                # packed-upload program variant has a pathological compile
                # cost — explicit upload_pack=True still enables it there
                if eligible and native.available() and packer == "native2":
                    self.upload_mode = "auto"
            elif eligible:
                if upload_pack == "delta" and bps > 16:
                    raise ValueError(
                        "upload_pack='delta' requires bits_per_sample <= 16 "
                        "(wrapped int16 deltas cannot represent hi-res "
                        f"samples; got bps={bps})"
                    )
                self.upload_mode = "delta" if upload_pack == "delta" else "on"
        self._eligible_pack = eligible
        # the delta16 wire reconstructs mod 2^16 — sound only for bps<=16
        self._delta_eligible = eligible and bps <= 16
        self._est = _link_est_for(
            _shape_bucket(batch_size * nch * block_size)
        )
        # wire kind of the LAST submitted batch ("raw" | "d" | "pack");
        # auto mode's racer takes it as the incumbent. A new pipeline in
        # auto mode starts from the estimator's bytes-ranked belief so a
        # fresh encode on a known-slow link doesn't re-pay raw batches.
        self._wire_kind = {"on": "pack", "delta": "d"}.get(
            self.upload_mode, "raw"
        )
        if self.upload_mode == "auto":
            kinds = (("raw", "d", "pack") if self._delta_eligible
                     else ("raw", "pack"))
            self._wire_kind = self._est.initial_kind(kinds)
        self.upload_pack = self._wire_kind != "raw"
        self._sharding = _auto_mesh(mesh, batch_size)
        self._in_flight: List[tuple] = []
        self._last_drain: Optional[float] = None
        self._prev_drain_kind: Optional[str] = None
        # last rice plan, reused across batches: the scan half of
        # try_pack (~5 ms/256-batch on the 1-core host) re-derives the
        # same ('r', order, p, Wu) tuple batch after batch on steady
        # content. Reuse is SAFE only for rice plans — pack_rice
        # overflow-checks the unary budget and falls back to a full
        # rescan, while a stale fixed-width plan would silently truncate
        # — and a periodic rescan bounds byte drift on evolving content.
        self._rice_plan: Optional[tuple] = None
        self._rice_plan_age = 0
        self.depth = constants.par.FRAMEBUF_MULTIPLICITY
        # one io thread per in-flight batch: a worker carries a batch's
        # FULL device lifetime (upload + dispatch + fetch + assembly,
        # mostly GIL-released waits), so fewer workers than `depth`
        # would cap concurrency below the pipeline bound
        self._pool = concurrent.futures.ThreadPoolExecutor(
            max_workers=max(2, self.depth)
        )
        # background wire-variant compilation (auto mode): a fresh wire's
        # first jit costs ~tens of seconds on remote-compile backends —
        # paid inline it stalls the stream AND poisons the racer's gap
        # estimate for that format. Instead the variant compiles on this
        # dedicated thread (remote compile barely touches the host CPU)
        # while batches keep shipping on an already-compiled wire; the
        # new format's first measured gap is then compile-free.
        self.async_compile = self.upload_mode == "auto" and not strict_lpc
        self._warming: dict = {}
        self._compile_pool = None
        self.max_inflight = 0
        # per-wire batch counts, e.g. {None: 3, ("r", 2, 7, 384): 21} —
        # surfaced in the corpus stats line so link adaptation is
        # observable; _wu_sticky keeps rice unary budgets monotone so
        # quiet batches reuse compiled programs
        self.wire_counts: dict = {}
        self._wu_sticky: dict = {}
        # grouped device roundtrip (see _FETCH_GROUP_AUTO): env pin, or
        # 0 for the measured-latency auto escalation
        self.fetch_group = int(os.environ.get("FLACENC_FETCH_GROUP", "0")
                               or 0)
        # fetch-only wall EWMA, SEEDED from the last pipeline in this
        # process: a fresh pipeline on a slow link used to need several
        # completed fetches before auto-grouping engaged, but on slow
        # links submission often outruns the first fetch entirely — a
        # short stream (one bench trial, one corpus file) could finish
        # submitting all batches per-batch before the EWMA was ever
        # set. Carrying the measurement across streams (like the
        # _WARMED_GROUPS registry carries the compiles) lets stream
        # N+1 group from its first batches; the grouped-path feedback
        # (see _roundtrip_group) still de-escalates when the link
        # recovers.
        self._fetch_ewma: Optional[float] = _LAST_FETCH_EWMA
        self._group_open: list = []  # [(payload, wire, chunk, nums, rate)]
        self._group_ref: Optional[dict] = None
        self.grouped_batches = 0      # stats: batches through group tasks
        self._group_warm = None       # background grouped-compile future
        self._group_wire = None       # wire of the warmed grouped program
        self._group_shapes: Optional[tuple] = None
        # opt-in per-batch event timeline (FLACENC_TIMELINE=1): absolute
        # perf_counter stamps appended from the main AND io threads
        # (list.append is atomic) so tools/overlap.py can reconstruct
        # which host stages actually hide under the link and which
        # serialize on the main thread. Off by default: ~zero cost, but
        # the events would bloat the stats dict on long streams.
        self.timeline: Optional[list] = (
            [] if os.environ.get("FLACENC_TIMELINE") else None
        )
        self._seq = 0  # submit sequence number (timeline batch id)

    def _mark(self, event: str, idx, *extra) -> None:
        if self.timeline is not None:
            import time as _time

            self.timeline.append((event, idx, _time.perf_counter()) + extra)

    def _put(self, a):
        if self._sharding is not None:
            return jax.device_put(a, self._sharding)
        return jnp.asarray(a)

    def _fn_for(self, wire):
        """Jitted program for a wire format (None = raw PCM upload)."""
        fn = self._fns.get(wire)
        if fn is None:
            fn = self._fns[wire] = _cached_encoder_fn(
                self.cfg.to_toml(), self.nch, self.bps, self.block_size,
                self.strict_lpc, self.packer == "native2",
                packed_wire=wire,
                wire_encoded=self.packer != "native2",
            )
        return fn

    def _warm_key(self, wire, shapes) -> tuple:
        return (self.cfg.to_toml(), self.nch, self.bps, self.block_size,
                self.strict_lpc, self.packer, wire, shapes,
                repr(self._sharding))

    def _wire_ready(self, wire, payload=()) -> bool:
        """True when `wire`'s program can run without compiling inline.

        Consults the process-wide `_WARMED_WIRES` registry first: a new
        pipeline (each stream/corpus encode creates one) must not re-pay
        the compile fallback for a program an earlier encode already
        compiled and executed at these shapes."""
        if wire is None or wire in self._fns:
            return True
        shapes = tuple((a.shape, str(a.dtype)) for a in payload)
        if self._warm_key(wire, shapes) in _WARMED_WIRES:
            self._fn_for(wire)  # instant: pulls the lru-cached, warm fn
            return True
        fut = self._warming.get(wire)
        if fut is not None and fut.done():
            fut.result()  # surface background compile errors
            self._fn_for(wire)  # instant: pulls the lru-cached, warm fn
            return True
        return False

    def _start_warm(self, wire, payload) -> None:
        """Compile + warm `wire`'s program in the background (zeros of
        the payload's shapes; transports compress zeros, so the warm
        upload is cheap even on slow links)."""
        if wire in self._warming:
            return
        import concurrent.futures

        if self._compile_pool is None:
            # 2 workers: compiles run on the (remote) compile server and
            # barely touch the host CPU — let both pre-warmed variants
            # compile concurrently
            self._compile_pool = concurrent.futures.ThreadPoolExecutor(
                max_workers=2
            )
        shapes = [(a.shape, a.dtype) for a in payload]

        key = self._warm_key(
            wire, tuple((s, str(np.dtype(d))) for s, d in shapes)
        )
        if key in _WARMED_WIRES:
            self._fn_for(wire)  # already hot process-wide; no re-warm
            return

        def warm():
            fn = _cached_encoder_fn(
                self.cfg.to_toml(), self.nch, self.bps, self.block_size,
                self.strict_lpc, self.packer == "native2",
                packed_wire=wire,
                wire_encoded=self.packer != "native2",
            )
            zeros = [self._put(np.zeros(s, d)) for s, d in shapes]
            jax.block_until_ready(fn(*zeros))
            _WARMED_WIRES.add(key)

        self._warming[wire] = self._compile_pool.submit(warm)
        # registry for wait_wire_warms; prune settled futures on append
        # so long-lived processes don't accumulate them unboundedly
        _WIRE_WARM_FUTURES[:] = [
            f for f in _WIRE_WARM_FUTURES if not f.done()
        ]
        _WIRE_WARM_FUTURES.append(self._warming[wire])

    def _prewarm(self, chunk) -> None:
        """Start background compiles of the delta16 wire (bps <= 16) and
        the dense wire the first batch's scan selects (one scan+pack to
        discover the tuple; its ~10 ms host cost is one-time)."""
        from ..ops import upack

        if self._delta_eligible:
            dwire, dpayload = upack.pack_delta(chunk)
            self._start_warm(dwire, dpayload)
        packed = upack.try_pack(chunk, self.bps)
        if packed is not None:
            wire, payload = packed
            if wire[0] == "r":  # pre-seed the sticky budget too
                self._wu_sticky[(wire[1], wire[2])] = wire[3]
            elif wire[0] == "m":
                _, om, pm, wum, os2, ps, wus = wire
                self._wu_sticky[("m", om, pm, os2, ps)] = (wum, wus)
            self._start_warm(wire, payload)

    def _try_pack_cached(self, chunk):
        """`upack.try_pack` with rice-plan reuse: skips the scan pass on
        steady content, falling back to the full scan when the cached
        plan's unary budget overflows, when the plan isn't rice, or
        every `_PLAN_RESCAN_EVERY` batches (bounds byte drift if the
        content's entropy slowly falls below the cached p)."""
        from .. import native
        from ..ops import upack

        plan = self._rice_plan
        self._rice_plan_age += 1
        if (plan is not None and plan[0] == "m"
                and self._rice_plan_age < _PLAN_RESCAN_EVERY):
            # mid/side plan reuse: pack at the plan's original per-plane
            # budgets; an overflow on either plane falls through to the
            # full rescan (same semantics as the "r" plan cache)
            _, om, pm, wum, os2, ps, wus = plan
            packed = upack.pack_ms(chunk, om, pm, wum, os2, ps, wus)
            if packed is not None:
                return plan, packed
        if (plan is not None and plan[0] == "r"
                and self._rice_plan_age < _PLAN_RESCAN_EVERY):
            _, order, p, wu = plan
            # pack at the plan's ORIGINAL unary budget: a chunk that
            # overflows it triggers the full try_pack rescan (fresh
            # (order, p) choice) instead of silently packing a louder
            # chunk under a stale plan at the (possibly larger) sticky
            # floor — advisor r4. On the steady path the floor equals
            # the plan's wu and submit()'s pad-to-floor stays a no-op;
            # only the rare floor>wu batch pays the concat copy there.
            packed = upack._pk_for(order)(chunk, order, p, wu)
            if packed is not None:
                return ("r", order, p, wu), packed
        packed_arrays = upack.try_pack(chunk, self.bps)
        self._rice_plan = (
            packed_arrays[0] if packed_arrays is not None else None
        )
        self._rice_plan_age = 0
        return packed_arrays

    def _fallback_wire(self, chunk):
        """Best already-compiled wire while the chosen one compiles:
        the delta16 variant if warm, else raw PCM."""
        d_wire = ("d", 2)
        if self._delta_eligible and d_wire in self._fns:
            from ..ops import upack

            return upack.pack_delta(chunk)
        if self.bps > 16 or chunk.dtype == np.int16:
            return None, (chunk,)
        return None, (chunk.astype(np.int16),)

    def _fetch(self, enc):
        """io thread: blocking device->host fetch + host-side split."""
        if self.packer == "native2":
            # decisions travel as ONE coalesced buffer = one round trip
            return split_decisions(np.asarray(jax.device_get(enc)), self.nch)
        # residual-shipping packers: (small decisions wire, errors) pair
        wire, errors = jax.device_get(enc)
        return split_encoded(np.asarray(wire), np.asarray(errors), self.nch)

    def _fetch_assemble(self, enc, chunk, nums, rate, seq=None):
        """io thread: blocking fetch + C++ frame assembly. Assembly
        (residual recompute + bit pack, GIL released) runs HERE so it
        fills the core during link waits instead of serializing after
        them on the main thread — on the 1-core bench host this removes
        the full assemble cost (~20 ms/256-batch) from the critical
        path whenever the link, not the CPU, is the bottleneck."""
        import time as _time

        self._mark("fetch_start", seq)
        t_f = _time.perf_counter()
        dec = self._fetch(enc)
        dt = _time.perf_counter() - t_f
        self._mark("fetch_done", seq)
        # fetch-only wall EWMA: steady slow fetches (serialized remote
        # round trips) escalate to the grouped fetch; concurrent io
        # threads may race this float — harmless, it gates a heuristic
        prev = self._fetch_ewma
        self._fetch_ewma = dt if prev is None else 0.7 * prev + 0.3 * dt
        global _LAST_FETCH_EWMA
        _LAST_FETCH_EWMA = self._fetch_ewma
        t0 = _time.perf_counter()
        frames = self.assemble(
            dec, chunk, nums, self.cfg, self.nch, self.bps,
            rate if rate is not None else 0, self.block_size,
        )
        self._mark("asm_done", seq)
        return frames, _time.perf_counter() - t0

    def _payload_shapes(self, payload) -> tuple:
        return tuple((tuple(a.shape), str(a.dtype)) for a in payload)

    def _group_fn(self, wire):
        """Jitted grouped program for a (wire, G) combo."""
        return _cached_encoder_fn(
            self.cfg.to_toml(), self.nch, self.bps, self.block_size,
            self.strict_lpc, self.packer == "native2",
            packed_wire=wire,
            wire_encoded=self.packer != "native2",
            grouped=self.fetch_group or _FETCH_GROUP_AUTO,
        )

    def _warm_group(self, wire, payload) -> None:
        """Background-compile + run the grouped program at this wire's
        payload shapes (an inline remote compile would stall the
        stream; zeros upload compressed, so warming is cheap even on
        slow links). Consults the process-wide _WARMED_GROUPS registry
        so later pipelines skip the re-warm."""
        import concurrent.futures

        if self._compile_pool is None:
            self._compile_pool = concurrent.futures.ThreadPoolExecutor(
                max_workers=2
            )
        g = self.fetch_group or _FETCH_GROUP_AUTO
        shapes = self._payload_shapes(payload)
        self._group_wire, self._group_shapes = wire, shapes
        key = (self._warm_key(wire, shapes), g)

        def warm():
            fn = self._group_fn(wire)
            if key in _WARMED_GROUPS:
                return
            zs = [jnp.zeros((g,) + s, d) for s, d in shapes]
            jax.block_until_ready(fn(*zs))
            _WARMED_GROUPS.add(key)

        if key in _WARMED_GROUPS:
            done: concurrent.futures.Future = concurrent.futures.Future()
            done.set_result(None)
            self._group_warm = done
            return
        self._group_warm = self._compile_pool.submit(warm)
        # prune settled futures on append: long-lived processes that
        # never call wait_group_warms must not accumulate one future per
        # wire flip / shape change forever (advisor r4)
        _GROUP_WARM_FUTURES[:] = [
            f for f in _GROUP_WARM_FUTURES if not f.done()
        ]
        _GROUP_WARM_FUTURES.append(self._group_warm)

    def _group_target(self, wire, payload) -> int:
        """Roundtrip-group size for THIS batch: 1 (ship alone) until
        slow fetches are measured and the grouped program is warm; then
        G. Only decisions-only (native2), unsharded batches matching
        the warmed (wire, shapes) group — anything else (a tail batch
        at a smaller bucket, a racer wire flip) would force an inline
        recompile, so it takes the per-batch path."""
        if self.packer != "native2" or self._sharding is not None:
            return 1
        g = self.fetch_group or _FETCH_GROUP_AUTO
        if g <= 1:
            return 1
        if not self.fetch_group:
            f = self._fetch_ewma
            if f is None or f <= _GROUP_FETCH_MIN_S:
                return 1
        if (self._group_warm is None or wire != self._group_wire
                or self._payload_shapes(payload) != self._group_shapes):
            self._warm_group(wire, payload)
            return 1
        if not self._group_warm.done():
            return 1
        self._group_warm.result()  # surface background compile errors
        return g

    def _flush_group(self) -> None:
        """Submit the open group as ONE io task: one stacked upload, one
        grouped dispatch, one (G, B, F) fetch, per-batch assembly."""
        entries, ref = self._group_open, self._group_ref
        self._group_open, self._group_ref = [], None
        if not entries or ref is None:
            return
        self.grouped_batches += len(entries)
        ref["future"] = self._pool.submit(self._roundtrip_group, entries)

    def _roundtrip_group(self, entries):
        """io thread: the whole group's device roundtrip. A full group
        stacks payload components host-side (a memcpy), uploads each
        stacked component ONCE, runs the lax.map-over-G program, and
        fetches ONE (G, B, F) decisions buffer — 3 serialized RPCs for
        G batches instead of ~3G. A partial (tail/forced-flush) group
        dispatches the per-batch program instead — it happens once per
        stream end or wire flip, and a fresh G would compile inline.
        Returns [(frames, pack_s)] in entry order."""
        import time as _time

        g = self.fetch_group or _FETCH_GROUP_AUTO
        self._mark("gtrip_start", id(entries), len(entries))
        if len(entries) == g:
            stacked = [
                np.stack([e[0][i] for e in entries])
                for i in range(len(entries[0][0]))
            ]
            enc_g = self._group_fn(entries[0][1])(*map(self._put, stacked))
            self._mark("gissued", id(entries), len(entries))
            t_f = _time.perf_counter()
            rows_all = np.asarray(jax.device_get(enc_g))  # (G, B, F)
            # feed the per-batch share of the grouped fetch back into the
            # fetch EWMA: without it auto-grouping was a one-way ratchet
            # (the EWMA only updated on the per-batch path, so a single
            # slow window engaged grouping forever) — now a recovered
            # link drives the amortized share under _GROUP_FETCH_MIN_S
            # and auto mode de-escalates to per-batch roundtrips
            dt = (_time.perf_counter() - t_f) / len(entries)
            prev = self._fetch_ewma
            self._fetch_ewma = dt if prev is None else 0.7 * prev + 0.3 * dt
            global _LAST_FETCH_EWMA
            _LAST_FETCH_EWMA = self._fetch_ewma
            self._mark("gfetch_done", id(entries), len(entries))
            parts = list(rows_all)
        else:
            encs = [
                self._fn_for(e[1])(*map(self._put, e[0])) for e in entries
            ]
            parts = [np.asarray(jax.device_get(e)) for e in encs]
        out = []
        for rows, (payload, wire, chunk, nums, rate) in zip(parts, entries):
            dec = split_decisions(np.ascontiguousarray(rows), self.nch)
            t0 = _time.perf_counter()
            frames = self.assemble(
                dec, chunk, nums, self.cfg, self.nch, self.bps,
                rate if rate is not None else 0, self.block_size,
            )
            out.append((frames, _time.perf_counter() - t0))
        self._mark("gasm_done", id(entries), len(entries))
        return out

    def _upload_dispatch_fetch(self, chunk, payload, wire, nums, rate):
        """io thread (STRICT mode only): strict host arrays + upload +
        dispatch + fetch + assembly. The native strict call releases the
        GIL, so computing the arrays here overlaps the read loop instead
        of serializing submit(). Non-strict batches take the async-issue
        path in submit() instead."""
        ext = _strict_ext_arrays(chunk, self.cfg, self.nch, self.bps,
                                 self.strict_window)
        enc = self._fn_for(wire)(*map(self._put, payload + ext))
        return self._fetch_assemble(enc, chunk, nums, rate)

    def _updf_plain(self, chunk, payload, wire, nums, rate, seq):
        """io thread: per-batch upload + dispatch + fetch + assembly.

        Running the upload here, off the main thread, hides a blocking
        `device_put` (a transport on which it does not return before the
        transfer completes) behind the read+pack of the next batch
        exactly as the fetch already hides the download. Dispatch order across
        pool threads is irrelevant for bytes: frames reassemble by
        `nums`, and batches share no device state."""
        enc = self._fn_for(wire)(*map(self._put, payload))
        self._mark("issued", seq)
        return self._fetch_assemble(enc, chunk, nums, rate, seq)

    def submit(self, blocks_list, nums: np.ndarray,
               rate: Optional[int] = None, cookie=None):
        """Queues one batch; returns a drained BatchResult once the
        pipeline is at depth, else None.

        `blocks_list` is a list of (C, T) blocks OR a premade (k, C, T)
        int32 array (the bulk `Source.read_blocks_batch` path — skips the
        per-block stack copy)."""
        seq = self._seq
        self._seq += 1
        self._mark("submit", seq)
        if isinstance(blocks_list, np.ndarray):
            chunk = _bucket_pad(blocks_list, self.batch_size)
        else:
            chunk = _bucket_pad(np.stack(blocks_list), self.batch_size)
        verify_sample_range(chunk, self.bps)
        kind = "raw"
        if self._eligible_pack:
            if self.upload_mode == "auto":
                # racer decision, re-read before EVERY batch: steady-state
                # drain gaps keep the per-wire estimates current and the
                # verdict may flip between any two batches (bytes never
                # change)
                kinds = (("raw", "d", "pack") if self._delta_eligible
                         else ("raw", "pack"))
                kind = self._est.choose(kinds, self._wire_kind)
            elif self.upload_mode == "on":
                kind = "pack"
            elif self.upload_mode == "delta":
                kind = "d"
        if (self.upload_mode == "auto" and self.async_compile
                and self._eligible_pack and not self.wire_counts
                and not self._warming):
            # pre-warm the exploration set from the FIRST batch's
            # statistics: the racer can only pick formats whose programs
            # exist, and a background compile takes longer than many
            # short encodes — starting both candidate compiles at stream
            # start (process-wide jit cache) means they are ready by the
            # time the racer wants them
            self._prewarm(chunk)
        packed_arrays = None
        if kind == "pack":
            packed_arrays = self._try_pack_cached(chunk)
        elif kind == "d":
            from ..ops import upack

            packed_arrays = upack.pack_delta(chunk)
        if packed_arrays is not None:
            wire, payload = packed_arrays
            if wire[0] == "r":
                # sticky unary budget: a quieter batch pads up to the
                # largest Wu already compiled for this (order, p) instead
                # of forking a new jit key (zero padding is decode-inert)
                _, o, p, wu = wire
                floor = self._wu_sticky.get((o, p), 0)
                if wu < floor:
                    lo, unary, firsts = payload
                    unary = np.concatenate(
                        [unary, np.zeros(
                            unary.shape[:-1] + (floor - wu,), np.uint32)],
                        axis=-1,
                    )
                    wire, payload = ("r", o, p, floor), (lo, unary, firsts)
                else:
                    self._wu_sticky[(o, p)] = wu
            elif wire[0] == "m":
                # per-plane sticky budgets (same jit-key economy as "r")
                from ..ops import upack
                _, om, pm, wum, os2, ps, wus = wire
                key = ("m", om, pm, os2, ps)
                fm, fs = self._wu_sticky.get(key, (0, 0))
                fm, fs = max(fm, wum), max(fs, wus)
                self._wu_sticky[key] = (fm, fs)
                if fm > wum or fs > wus:
                    payload = upack.pad_ms_unary(payload, wum, wus, fm, fs)
                    wire = ("m", om, pm, fm, os2, ps, fs)
        else:
            wire = None
            if self.bps > 16:
                up = chunk
            elif chunk.dtype == np.int16:  # narrow-storage fast path
                up = chunk
            else:
                up = chunk.astype(np.int16)
            payload = (up,)
        if self.async_compile and not self._wire_ready(wire, payload):
            # compile the fresh variant off-thread; ship THIS batch on a
            # warm wire so the stream never stalls on a compile
            self._start_warm(wire, payload)
            wire, payload = self._fallback_wire(chunk)
        upload_bytes = sum(a.nbytes for a in payload)
        # actual kind used (try_pack may fall back to raw) — incumbent
        # for the next racer decision, attribution key for drain gaps
        self._wire_kind = (
            "raw" if wire is None else ("d" if wire[0] == "d" else "pack")
        )
        self._mark("packed", seq, self._wire_kind, upload_bytes)
        self.upload_pack = wire is not None
        self.wire_counts[wire] = self.wire_counts.get(wire, 0) + 1
        nums = np.asarray(nums)
        if len(nums) < chunk.shape[0]:  # padding rows get dummy numbers
            nums = np.concatenate(
                [nums, np.zeros(chunk.shape[0] - len(nums), nums.dtype)]
            )
        if self.strict_lpc:
            # strict host arrays are expensive: keep the whole chain on
            # the io thread so it overlaps the read loop
            fut = self._pool.submit(
                self._upload_dispatch_fetch, chunk, payload, wire, nums,
                rate,
            )
        else:
            # async-issue fast path: device_put returns before the
            # transfer completes and the dispatch is non-blocking, so the
            # transport queues this batch's upload NOW (transfers and
            # in-order device execution overlap the io thread's fetches);
            # the blocking fetch AND the C++ frame assembly go to the
            # pool (see _fetch_assemble)
            if self._group_open and (
                    self._group_open[0][1] != wire
                    or self._payload_shapes(self._group_open[0][0])
                    != self._payload_shapes(payload)):
                # racer wire flip / payload shape change: ship the open
                # group now so mixed payloads never stack into one
                # grouped program
                self._flush_group()
            if self._group_target(wire, payload) > 1:
                # grouped roundtrip: park this batch's HOST payload in
                # the open group; ONE io task uploads + dispatches +
                # fetches the whole group when it fills (or at
                # drain_all / a forced drain)
                if self._group_ref is None:
                    self._group_ref = {"future": None, "kinds": [],
                                       "bytes": []}
                ref = self._group_ref
                fut = ("g", ref, len(self._group_open))
                self._group_open.append((payload, wire, chunk, nums, rate))
                ref["kinds"].append(self._wire_kind)
                ref["bytes"].append(upload_bytes)
                self._mark("parked", seq)
                if len(self._group_open) >= self._group_target(wire,
                                                               payload):
                    self._flush_group()
            elif os.environ.get("FLACENC_INLINE_DISPATCH"):
                # measurement kill-switch: the pre-r5 inline issue path
                enc = self._fn_for(wire)(*map(self._put, payload))
                self._mark("issued", seq)
                fut = self._pool.submit(self._fetch_assemble, enc, chunk,
                                        nums, rate, seq)
            else:
                fut = self._pool.submit(self._updf_plain, chunk, payload,
                                        wire, nums, rate, seq)
        self._in_flight.append(
            (fut, nums, len(blocks_list), cookie, upload_bytes,
             self._wire_kind)
        )
        self.max_inflight = max(self.max_inflight, len(self._in_flight))
        if len(self._in_flight) >= self.depth:
            return self.drain_one()
        return None

    def drain_one(self) -> Optional[BatchResult]:
        if not self._in_flight:
            return None
        import time as _time

        saturated = len(self._in_flight) >= 2
        fut, nums, n_valid, cookie, up_bytes, wire_kind = (
            self._in_flight.pop(0)
        )
        self._mark("drain_start", None)
        t0 = _time.perf_counter()
        if isinstance(fut, tuple) and fut[0] == "g":
            # grouped-fetch entry: groups flush in submit order and
            # drains pop oldest-first, so an unflushed ref here IS the
            # open group (the stream ended or a drain was forced before
            # it filled)
            _, ref, idx = fut
            if ref["future"] is None:
                self._flush_group()
            if ref["future"] is None:  # defensive: flush must set it
                raise RuntimeError("grouped fetch entry lost its group")
            group_out = ref["future"].result()
            batch_frames, pack_s = group_out[idx]
            t1 = _time.perf_counter()
            if idx == len(group_out) - 1:
                # one racer sample per group: the gap since the previous
                # group-final drain spans the whole group, so normalize
                # to per-batch units; only a kind-homogeneous group
                # following the same kind attributes cleanly
                g = len(group_out)
                kinds = ref.get("kinds", [wire_kind])
                if (self._last_drain is not None and saturated
                        and all(k == wire_kind for k in kinds)
                        and wire_kind == self._prev_drain_kind):
                    mean_bytes = sum(ref.get("bytes", [up_bytes])) / g
                    self._est.update(
                        mean_bytes, (t1 - self._last_drain) / g, wire_kind
                    )
                self._prev_drain_kind = wire_kind
                self._last_drain = t1
            self._mark("drain_done", None)
            return BatchResult(batch_frames[:n_valid], nums[:n_valid],
                               cookie, t1 - t0, pack_s)
        batch_frames, pack_s = fut.result()
        t1 = _time.perf_counter()
        if (self._last_drain is not None and saturated
                and wire_kind == self._prev_drain_kind):
            # steady-state completion gap = bottleneck stage time; feeds
            # the racer (LinkEstimator) only when this batch and its
            # predecessor share a wire kind — a gap after a wire flip
            # measures the mixed window, not this wire
            self._est.update(up_bytes, t1 - self._last_drain, wire_kind)
        self._prev_drain_kind = wire_kind
        self._last_drain = t1
        self._mark("drain_done", None)
        return BatchResult(batch_frames[:n_valid], nums[:n_valid], cookie,
                           t1 - t0, pack_s)

    def drain_all(self):
        if self._group_open:
            self._flush_group()
        while self._in_flight:
            yield self.drain_one()

    def close(self):
        self._pool.shutdown(wait=False)
        if self._compile_pool is not None:
            self._compile_pool.shutdown(wait=False)


def _mesh_device_count(mesh, batch_size: int) -> int:
    """Devices the batch axis WOULD shard over at this batch size
    (0 = no sharding): explicit `Mesh` -> its device count; "auto" ->
    the local device count when `_auto_mesh` would engage it. Used by
    the short-stream batch clamp so it never shrinks the batch to a
    size the sharding can't split."""
    if mesh is None:
        return 0
    if mesh == "auto":
        import jax

        if jax.process_count() > 1:
            return 0
        n = len(jax.local_devices())
        return n if n > 1 and batch_size % n == 0 else 0
    return int(mesh.devices.size)


def _auto_mesh(mesh, batch_size: int):
    """Resolve the `mesh` argument: "auto" shards the batch axis across all
    local devices when there is more than one and the batch divides evenly
    (frame-level data parallelism over ICI, the par.rs worker-pool map —
    SURVEY §2.2). Returns a NamedSharding for `(B, ...)` inputs or None."""
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    from ..parallel import mesh as pmesh

    if mesh == "auto":
        if jax.process_count() > 1:
            # multi-process (DCN) runs encode per host on its corpus shard;
            # sharding a host-local batch across processes would require
            # identical data on every host
            return None
        devices = jax.local_devices()
        if len(devices) > 1 and batch_size % len(devices) == 0:
            mesh = pmesh.block_mesh(devices)
        else:
            return None
    if mesh is None:
        return None
    return NamedSharding(mesh, P(pmesh.BLOCK_AXIS))


def encode_with_fixed_block_size(
    config: Verified[config_mod.Encoder] | config_mod.Encoder,
    src: Source,
    block_size: int,
    batch_size: int = DEFAULT_BATCH,
    packer: str = "auto",
    strict_lpc: Optional[bool] = None,
    mesh="auto",
    upload_pack="env",
    stats: Optional[dict] = None,
) -> "Stream":
    """Batched device stream encoder (public entry).

    Full blocks run through the device pipeline in batches; the ragged tail
    block (if any) is encoded by the scalar oracle so that device programs
    stay shape-static (DESIGN.md "tail handling").

    `strict_lpc` (or env FLACENC_STRICT_LPC=1) computes QLPC coefficients
    host-side with exact stable-reference float semantics (sequential-FMA
    f64; native strict_qlpc) so streams are byte-identical to the
    reference's stable build for matching configs.

    `mesh`: "auto" (default) shards each batch across all local devices on
    the leading block axis when possible; pass a `jax.sharding.Mesh` with a
    "blocks" axis to control placement, or None to pin to one device.
    Blocks are independent, so sharding changes throughput, never bytes.

    `stats`: optional dict filled in-place with wall-clock stage totals
    (read_s, submit_s, device_wait_s, pack_s, batches, frames) so callers
    (bench.py, the CLI) can report where end-to-end time goes — the
    host-side ceiling is everything except `device_wait_s`.

    `upload_pack`: "env" (default) consults FLACENC_PACKED_UPLOAD
    ("1" forces the dense packed wire, "d" the delta16 wire, "auto" the
    per-wire-format racer, which measures each format's steady-state
    batch gap and may flip between any two batches; unset or "0" = raw
    PCM); "auto" selects the racer; True forces the dense wire (raises if
    bps/block size are ineligible); False uploads raw PCM. The wire
    format never changes output bytes.
    """
    import os as _os

    explicit_strict = strict_lpc is True
    if strict_lpc is None:
        strict_lpc = _os.environ.get("FLACENC_STRICT_LPC", "") == "1"
    if isinstance(config, Verified):
        _sub = config.inner.subframe_coding
    else:
        _sub = config.subframe_coding
    if _sub.qlpc.use_direct_mse:
        # strict mode covers the autocorrelation method only; refuse an
        # EXPLICIT request instead of silently downgrading (env-derived
        # strictness falls back to the documented default semantics)
        if explicit_strict:
            raise ValueError(
                "strict_lpc covers the autocorrelation method; the "
                "experimental direct-MSE/IRLS estimators have no strict "
                "float path (the reference gates them behind the "
                "'experimental' feature)"
            )
        strict_lpc = False
    from ..component.datatype import Stream

    cfg = config.inner if isinstance(config, Verified) else config
    nch = src.channels()
    bps = src.bits_per_sample()
    rate = src.sample_rate()
    stream = Stream(rate, nch, bps)
    # MD5 on a dedicated worker behind a bounded queue (par.rs:196-277):
    # the read loop never waits on hashing unless the queue backs up
    context = AsyncContext(bps, nch)

    frames: List[Frame] = []
    tail: Optional[np.ndarray] = None
    framebuf = FrameBuf(nch, block_size)
    total_hint = src.len_hint()
    if total_hint is not None:
        full_blocks = total_hint // block_size
        if 0 < full_blocks < batch_size:
            # short stream: the single padded batch would burn device
            # time on padding rows (a 3 s clip = 32 blocks padded to 64
            # doubles the compute). Clamp to the next power of two so
            # padding stays < 2x while jit keys stay few (a power-of-2
            # ladder, not one program per odd file length). Never RAISE
            # the caller's explicit batch_size: a small/odd request
            # (e.g. one sized to divide a device mesh) must survive.
            cand = max(8, 1 << (int(full_blocks) - 1).bit_length())
            n_dev = _mesh_device_count(mesh, batch_size)
            if n_dev:
                # a sharded batch axis must stay a (positive) multiple
                # of the mesh's device count: an unrounded clamp would
                # crash device_put on an explicit mesh and silently
                # de-shard mesh="auto" for short clips
                cand = -(-max(cand, n_dev) // n_dev) * n_dev
            batch_size = min(batch_size, cand)
    pipe = BatchPipeline(
        cfg, nch, bps, block_size, batch_size, packer, strict_lpc, mesh,
        upload_pack,
    )

    import time as _time

    _acc = {"read_s": 0.0, "submit_s": 0.0, "device_wait_s": 0.0,
            "pack_s": 0.0, "batches": 0}
    _t_start = _time.perf_counter()

    def drained(result):
        if result is not None:
            frames.extend(result.frames)
            _acc["device_wait_s"] += result.device_wait_s
            _acc["pack_s"] += result.pack_s
            _acc["batches"] += 1

    def timed_submit(blocks, nums):
        t0 = _time.perf_counter()
        drained(pipe.submit(blocks, nums, rate=rate))
        _acc["submit_s"] += _time.perf_counter() - t0

    try:
        pending: List[np.ndarray] = []
        n_full = 0
        # bulk fast path: sources backed by stable memory/files hand the
        # encoder whole (k, C, T) batches with ONE md5 fill and ONE
        # deinterleave pass (the per-block loop costs ~5 ms/256-block
        # batch in copies + hash-queue items on a single-core host)
        t0 = _time.perf_counter()
        pipe._mark("read_start", 0)
        bulk = src.read_blocks_batch(batch_size, block_size, context)
        pipe._mark("read_done", 0)
        _acc["read_s"] += _time.perf_counter() - t0
        if bulk is not None:
            while True:
                k = bulk.shape[0]
                if k:
                    timed_submit(bulk, np.arange(n_full, n_full + k))
                    n_full += k
                if k < batch_size:
                    break  # no further full block exists
                t0 = _time.perf_counter()
                pipe._mark("read_start", n_full // batch_size)
                bulk = src.read_blocks_batch(batch_size, block_size, context)
                pipe._mark("read_done", n_full // batch_size)
                _acc["read_s"] += _time.perf_counter() - t0
        while True:
            t0 = _time.perf_counter()
            read = src.read_samples(block_size, (framebuf, context))
            _acc["read_s"] += _time.perf_counter() - t0
            if read == 0:
                break
            if read == block_size:
                pending.append(framebuf.samples.copy())
                if len(pending) == batch_size:
                    timed_submit(pending,
                                 np.arange(n_full, n_full + batch_size))
                    n_full += batch_size
                    pending = []
            else:
                # a short read is the final (tail) block by the Source
                # contract (source.rs:462; MemSource/WavFileSource only
                # short-read at EOF) — stop so frame order stays sequential
                tail = framebuf.samples[:, :read].copy()
                break
        if pending:
            timed_submit(pending, np.arange(n_full, n_full + len(pending)))
        for result in pipe.drain_all():
            drained(result)
    finally:
        pipe.close()
        context.shutdown()  # join the MD5 worker (no-op if already done)

    if tail is not None:
        fb = FrameBuf(nch, tail.shape[1])
        fb.fill_interleaved(np.ascontiguousarray(tail.T).reshape(-1))
        frames.append(
            reference_encoder.encode_fixed_size_frame(
                cfg, fb, len(frames), stream.stream_info(), strict_lpc=strict_lpc
            )
        )

    for frame in frames:
        stream.add_frame(frame)
    if stream.frame_count() > 0:
        mx = stream.stream_info().max_block_size
        stream.stream_info_mut().set_block_sizes(mx, mx)
    stream.stream_info_mut().set_md5_digest(context.md5_digest())
    total = src.len_hint()
    stream.stream_info_mut().set_total_samples(
        total if total is not None else context.total_samples()
    )
    if stats is not None:
        stats.update(
            wall_s=_time.perf_counter() - _t_start,
            frames=len(frames),
            packer=pipe.packer,
            link_mbps=round(pipe._est.mbps, 1) if pipe._est.mbps else None,
            wire_batches={repr(k): v for k, v in pipe.wire_counts.items()},
            grouped_batches=pipe.grouped_batches,
            **_acc,
        )
        if pipe.timeline is not None:
            stats["timeline"] = list(pipe.timeline)
    from ..log import info_stats

    # stream-path run stats (the par-mode JSONL line, par.rs:414-421)
    info_stats(
        event="stream_encode",
        frames=len(frames),
        batches=sum(pipe.wire_counts.values()),
        wire_batches={repr(k): v for k, v in pipe.wire_counts.items()},
        link_mbps=round(pipe._est.mbps, 1) if pipe._est.mbps else None,
        md5_overdue=context.worker.overdue,
        max_inflight_batches=pipe.max_inflight,
    )
    return stream

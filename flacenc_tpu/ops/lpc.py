"""Batched quantized-LPC kernels: windowing, autocorrelation, Levinson,
quantization, residual FIR.

Batched reformulation of ``/root/reference/src/lpc.rs``:

- windowing is an f32 elementwise product with a precomputed (bit-exact)
  window (lpc.rs:739-756);
- autocorrelation is a batched f64 lagged reduction over `(..., T)` with
  the reference's warm-up exclusion (lpc.rs:542-548);
- Levinson-Durbin is vectorized over the batch and unrolled over the
  (static) order, with the diagonal-loading retry implemented as a masked
  `lax.while_loop` (lpc.rs:633-705);
- `find_shift` uses frexp instead of ceil(log2()) — mathematically exact,
  no transcendental (lpc.rs:234-254);
- the residual FIR always runs in i64 and wraps to i32, provably matching
  the reference's dual i32/i64 overflow strategy (lpc.rs:306-390).
"""

from __future__ import annotations

from typing import Tuple

from . import jax_env  # noqa: F401

import jax
import jax.numpy as jnp
import numpy as np

from .. import constants

MAX_LPC_ORDER = constants.qlpc.MAX_ORDER  # 24


def apply_window(signal: jnp.ndarray, window: np.ndarray) -> jnp.ndarray:
    """(..., T) i32 -> f32 windowed signal."""
    return signal.astype(jnp.float32) * jnp.asarray(window, dtype=jnp.float32)


def auto_correlation(sig_f32: jnp.ndarray, lpc_order: int) -> jnp.ndarray:
    """(..., T) f32 -> (..., order+1) f64 lagged products.

    corr[tau] = sum_{t >= order} x[t] * x[t-tau] (order = lpc_order; the
    reference passes `order+1` lags and excludes the first `order` frames).
    """
    x = sig_f32.astype(jnp.float64)
    T = x.shape[-1]
    warm = lpc_order
    y = x[..., warm:]
    lags = [
        (y * x[..., warm - tau : T - tau]).sum(axis=-1)
        for tau in range(lpc_order + 1)
    ]
    return jnp.stack(lags, axis=-1)


def levinson(corr: jnp.ndarray, lpc_order: int) -> jnp.ndarray:
    """Batched symmetric-Toeplitz solve (lpc.rs:633-705).

    corr: (..., order+1) f64. Solves T x = y with T[i][j] = corr[|i-j|],
    y = corr[1:]. Returns (..., order) f64 coefficients. Digital silence
    (corr[0] == 0) yields zeros. An order whose reflection denominator is
    exactly zero is SKIPPED (forward/dest kept): the reference's `continue`
    binds to its inner `for n` loop, so its diagonal-loading retry is dead
    code (its own `#[allow(clippy::never_loop)]` confirms the outer loop
    never repeats, lpc.rs:664-683) — a per-order masked skip reproduces
    the compiled behavior exactly, batched.
    """
    batch_shape = corr.shape[:-1]
    coefs = corr[..., :lpc_order]
    ys = corr[..., 1 : lpc_order + 1]
    silent = corr[..., 0] == 0.0

    c0 = coefs[..., 0]
    safe_c0 = jnp.where(c0 == 0.0, 1.0, c0)
    forward = jnp.zeros(batch_shape + (lpc_order,))
    dest = jnp.zeros(batch_shape + (lpc_order,))
    forward = forward.at[..., 0].set(1.0 / safe_c0)
    dest = dest.at[..., 0].set(ys[..., 0] / safe_c0)
    for n in range(1, lpc_order):
        # error = sum_{d<n} coefs[n-d] * forward[d]
        cn = jnp.flip(coefs[..., 1 : n + 1], axis=-1)
        error = (cn * forward[..., :n]).sum(axis=-1)
        denom = 1.0 - error * error
        skip = denom == 0.0
        safe_denom = jnp.where(skip, 1.0, denom)
        alpha = 1.0 / safe_denom
        beta = -alpha * error
        fwd_rev = jnp.flip(forward[..., : n + 1], axis=-1)
        fwd_next = alpha[..., None] * forward[..., : n + 1] + beta[..., None] * fwd_rev
        fwd_next = jnp.where(skip[..., None], forward[..., : n + 1], fwd_next)
        forward = forward.at[..., : n + 1].set(fwd_next)
        delta = (cn * dest[..., :n]).sum(axis=-1)
        upd = (ys[..., n] - delta)[..., None] * jnp.flip(
            forward[..., : n + 1], axis=-1
        )
        upd = jnp.where(skip[..., None], 0.0, upd)
        dest = dest.at[..., : n + 1].set(dest[..., : n + 1] + upd)
    return jnp.where(silent[..., None], 0.0, dest)


def find_shift(coefs: jnp.ndarray, precision: int) -> jnp.ndarray:
    """Quantization shift per batch element (lpc.rs:234-254), exact.

    ceil(log2(x)) = smallest integer k with 2^k >= x. jnp.log2 gives k
    within one ulp; one exact exp2 comparison in each direction corrects it
    (exp2 of an integer is exact in f64) without frexp's bitcast.
    """
    max_abs = jnp.max(jnp.abs(coefs), axis=-1)
    safe = jnp.where(max_abs == 0.0, 1.0, max_abs)
    k0 = jnp.ceil(jnp.log2(safe))
    k0 = jnp.clip(k0, -1020.0, 1020.0)  # keep exp2 exact/finite
    k = k0 + (jnp.exp2(k0) < safe) - (jnp.exp2(k0 - 1.0) >= safe)
    abs_log2 = k.astype(jnp.int32)
    abs_log2 = jnp.where(max_abs == 0.0, -32752, abs_log2)  # log2(0) clamp
    abs_log2 = jnp.maximum(abs_log2, -32752)
    shift = (precision - 1) - abs_log2
    return jnp.clip(
        shift, constants.qlpc.MIN_SHIFT, constants.qlpc.MAX_SHIFT
    ).astype(jnp.int32)


def _round_half_away(x: jnp.ndarray) -> jnp.ndarray:
    """Rust f64::round: nearest, half away from zero; no double rounding."""
    f = jnp.floor(jnp.abs(x))
    frac = jnp.abs(x) - f
    mag = f + (frac >= 0.5)
    return jnp.where(x < 0, -mag, mag)


def quantize_parameters(
    coefs: jnp.ndarray, precision: int
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """(..., order) f64 -> (qcoefs (..., MAX_LPC_ORDER) i32, order (...,) i32,
    shift (...,) i32); mirrors lpc.rs:273-302 incl. tail-zero truncation."""
    lpc_order = coefs.shape[-1]
    shift = find_shift(coefs, precision)
    scale = jnp.exp2(shift.astype(jnp.float64))
    scaled = _round_half_away(coefs * scale[..., None])
    scaled = jnp.clip(scaled, -32768.0, 32767.0)  # i16 clamp
    lim_lo = -(1 << (precision - 1))
    lim_hi = (1 << (precision - 1)) - 1
    q = jnp.clip(scaled.astype(jnp.int32), lim_lo, lim_hi)
    pad = MAX_LPC_ORDER - lpc_order
    if pad:
        q = jnp.pad(q, [(0, 0)] * (q.ndim - 1) + [(0, pad)])
    idx = jnp.arange(1, MAX_LPC_ORDER + 1, dtype=jnp.int32)
    order = jnp.max(jnp.where(q != 0, idx, 0), axis=-1)
    order = jnp.maximum(order, 1)
    # zero out coefficients at/after the truncated order (they are zero
    # already by construction, but make it explicit for downstream masks)
    mask = jnp.arange(MAX_LPC_ORDER) < order[..., None]
    return jnp.where(mask, q, 0), order, shift


def compute_error(
    qcoefs: jnp.ndarray, order: jnp.ndarray, shift: jnp.ndarray, signal: jnp.ndarray,
    max_taps: int = MAX_LPC_ORDER,
) -> jnp.ndarray:
    """QLPC residual FIR (lpc.rs:306-390), i64-exact, wrapped to i32.

    qcoefs: (..., MAX_LPC_ORDER) i32 (zeros beyond order); signal (..., T).
    err[t] = x[t] - ((sum_k c[k] * x[t-1-k]) >> shift) for t >= order, else 0.
    `max_taps` statically caps the unrolled FIR at the config's lpc_order
    (quantize_parameters zero-truncates coefficients beyond it, so the
    skipped taps contribute exactly zero); default config order is 10,
    saving 14/24 of the i64 multiply-add passes.
    """
    x = signal.astype(jnp.int64)
    T = signal.shape[-1]
    acc = jnp.zeros_like(x)
    for k in range(min(max_taps, MAX_LPC_ORDER)):
        c = qcoefs[..., k].astype(jnp.int64)[..., None]
        shifted = jnp.pad(
            x[..., : T - k - 1], [(0, 0)] * (x.ndim - 1) + [(k + 1, 0)]
        )
        acc = acc + c * shifted
    err = x - (acc >> shift.astype(jnp.int64)[..., None])
    t_idx = jnp.arange(T, dtype=jnp.int32)
    err = jnp.where(t_idx < order[..., None], 0, err)
    # wrap to i32 two's complement (Rust `as i32`)
    wrapped = ((err + jnp.int64(1 << 31)) & jnp.int64(0xFFFFFFFF)) - jnp.int64(1 << 31)
    return wrapped.astype(jnp.int32)


# ---------------------------------------------------------------------------
# Experimental LPC estimation on device (lpc.rs:813-913)
# ---------------------------------------------------------------------------


def lagged_outer_prod_sum(win: jnp.ndarray, lpc_order: int, weights=None) -> jnp.ndarray:
    """Batched covariance matrix M[i,j] = sum_t s[t-i] s[t-j] w(t+1).

    `win`: (..., T) f32 windowed signal; uses s = win[..., :-1] and
    t in [order-1, T-2] like the reference's ShiftedWeight<1> call
    (lpc.rs:878-883). Weight application is f32. The contraction is a
    batched (order, T') x (T', order) f64 matrix product.
    """
    s32 = win[..., :-1]
    T1 = s32.shape[-1]
    lo = lpc_order - 1
    # S[..., i, t] = s[t + lo - i] for t in [0, T1-lo)
    rows = [s32[..., lo - i : T1 - i] for i in range(lpc_order)]
    S32 = jnp.stack(rows, axis=-2)  # (..., order, T') f32
    S = S32.astype(jnp.float64)
    if weights is not None:
        w_t = weights[..., None, lo + 1 : T1 + 1].astype(jnp.float32)
        Wside = (S32 * w_t).astype(jnp.float64)
    else:
        Wside = S
    return jnp.einsum("...it,...jt->...ij", S, Wside)


def cholesky_solve_spd(M: jnp.ndarray, y: jnp.ndarray) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Batched unrolled Cholesky solve; returns (x, failed).

    failed=True where M is not SPD (non-positive pivot), mirroring
    nalgebra's failure that triggers the reference's regularization retry
    (lpc.rs:885-894). Unrolled over the (static, <=32) order — no linalg
    HLOs.
    """
    n = y.shape[-1]
    batch = y.shape[:-1]
    L = jnp.zeros(batch + (n, n), dtype=jnp.float64)
    failed = jnp.zeros(batch, dtype=bool)
    for j in range(n):
        d = M[..., j, j] - sum(L[..., j, k] ** 2 for k in range(j))
        failed = failed | (d <= 0.0) | jnp.isnan(d)
        dj = jnp.sqrt(jnp.where(d <= 0.0, 1.0, d))
        L = L.at[..., j, j].set(dj)
        for i in range(j + 1, n):
            off = M[..., i, j] - sum(L[..., i, k] * L[..., j, k] for k in range(j))
            L = L.at[..., i, j].set(off / dj)
    # forward substitution L z = y
    z = jnp.zeros_like(y)
    for i in range(n):
        acc = y[..., i] - sum(L[..., i, k] * z[..., k] for k in range(i))
        z = z.at[..., i].set(acc / L[..., i, i])
    # backward substitution L^T x = z
    x = jnp.zeros_like(y)
    for i in range(n - 1, -1, -1):
        acc = z[..., i] - sum(L[..., k, i] * x[..., k] for k in range(i + 1, n))
        x = x.at[..., i].set(acc / L[..., i, i])
    return x, failed


def _solve_spd_with_retry(M: jnp.ndarray, y: jnp.ndarray) -> jnp.ndarray:
    n = y.shape[-1]
    eye = jnp.eye(n, dtype=jnp.float64)

    def attempt(reg):
        Mr = M + reg[..., None, None] * eye
        return cholesky_solve_spd(Mr, y)

    x0, f0 = attempt(jnp.zeros(y.shape[:-1]))

    def cond(state):
        _, failed, _ = state
        return jnp.any(failed)

    def body(state):
        _, failed, reg = state
        new_reg = jnp.where(failed, jnp.maximum(1.0, reg + reg), reg)
        x, f = attempt(new_reg)
        return x, f & failed, new_reg

    x, _, _ = jax.lax.while_loop(cond, body, (x0, f0, jnp.zeros(y.shape[:-1])))
    return x


def weighted_auto_correlation(
    win: jnp.ndarray, lpc_order: int, weights=None
) -> jnp.ndarray:
    """corr[tau] = sum_{t>=order} x[t-tau] * f64(f32(w[t] x[t]))."""
    x = win.astype(jnp.float64)
    T = x.shape[-1]
    warm = lpc_order
    if weights is not None:
        wy = (win[..., warm:] * weights[..., warm:].astype(jnp.float32)).astype(
            jnp.float32
        ).astype(jnp.float64)
    else:
        wy = x[..., warm:]
    lags = [
        (wy * x[..., warm - tau : T - tau]).sum(axis=-1)
        for tau in range(lpc_order + 1)
    ]
    return jnp.stack(lags, axis=-1)


def lpc_direct_mse(win: jnp.ndarray, lpc_order: int, weights=None) -> jnp.ndarray:
    """Direct-MSE (covariance) LPC on device (lpc.rs:853-913)."""
    corr = weighted_auto_correlation(win, lpc_order, weights)
    M = lagged_outer_prod_sum(win, lpc_order, weights)
    return _solve_spd_with_retry(M, corr[..., 1:])


def compute_raw_errors_f32(signal: jnp.ndarray, coefs: jnp.ndarray) -> jnp.ndarray:
    """Float prediction errors err[t] = pred - signal (lpc.rs:606-618)."""
    order = coefs.shape[-1]
    sig = signal.astype(jnp.float32)
    T = sig.shape[-1]
    err = -sig
    for j in range(order):
        c = coefs[..., j].astype(jnp.float32)[..., None]
        shifted = jnp.pad(sig[..., : T - 1 - j], [(0, 0)] * (sig.ndim - 1) + [(j + 1, 0)])
        err = c * shifted + err
    t_idx = jnp.arange(T)
    return jnp.where(t_idx < order, 0.0, err)


def lpc_irls_mae(
    signal: jnp.ndarray, win: jnp.ndarray, lpc_order: int, steps: int
) -> jnp.ndarray:
    """IRLS mean-absolute-error LPC on device (lpc.rs:814-850)."""
    T = signal.shape[-1]
    batch = signal.shape[:-1]
    weights = jnp.ones(batch + (T,), dtype=jnp.float32)
    best = jnp.zeros(batch + (lpc_order,), dtype=jnp.float64)
    best_err = jnp.full(batch, jnp.inf, dtype=jnp.float32)
    normalizer = jnp.max(jnp.abs(signal), axis=-1).astype(jnp.float32)[..., None]
    t_idx = jnp.arange(T)
    for _ in range(steps + 1):
        coefs = lpc_direct_mse(win, lpc_order, weights)
        raw = compute_raw_errors_f32(signal, coefs)
        sum_abs = jnp.abs(raw).sum(axis=-1, dtype=jnp.float32)
        better = sum_abs < best_err
        best = jnp.where(better[..., None], coefs, best)
        best_err = jnp.where(better, sum_abs, best_err)
        w = jnp.maximum(
            jnp.maximum(jnp.abs(raw), 1.0) / normalizer, 0.01
        ) ** jnp.float32(-1.2)
        weights = jnp.where(t_idx < lpc_order, weights, w)
    return best

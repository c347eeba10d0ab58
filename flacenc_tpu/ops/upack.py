"""Packed host->device wire formats for PCM uploads.

On a link-starved host (a device reached over a slow remote link) the
raw int16 PCM upload is the end-to-end ceiling. The host ships fixed-order
delta residuals `d[t] = diff^order(x)[t]` (orders 1-4, FLAC's own
fixed-predictor range; warm-up values travel separately as int32 —
[x0, x1] for orders 1-2, the four difference warm-ups (Δ^j x)[j] for
orders 3-4) in one of TWO formats, and the device reconstructs exactly
with static-shape integer ops — output bytes NEVER depend on the wire
(wrapping int32 semantics match numpy's diff bit for bit). Orders 3-4
matter on oversampled hi-res material, where each extra differencing
level cuts the tonal residual by another factor 2*sin(pi*f/fs):
measured 12.8 -> 9.5 bits/sample on the 24/96 bench content (order 3),
a 25% upload cut the order-1/2 wires cannot reach.

("w", order, width) — fixed-width: little-endian `width`-bit
two's-complement fields, width in {8..12, 14, 16, 18, 20} (odd widths
need T %% 32 == 0). Decode = static shifts + cumsum(s). The widths
above 12 only matter for hi-res input (bps 17..24, which would
otherwise upload raw int32 at 4 B/sample); for bps <= 16 `try_pack`
rejects any format that does not beat the plain int16 upload.

("r", order, p, Wu) — rice-coded (entropy): zigzag z of the deltas
splits into a fixed p-bit low plane (same field layout) and a unary
quotient substream (q = z >> p as q zeros then a one, LSB-first,
zero-padded to the static per-row word budget Wu). Decode is fully
parallel: each zero bit belongs to the sample indexed by the count of
one bits before it, so quotients are a cumsum + scatter-add — no
sequential bit cursor, no data-dependent shapes. On the bench corpus
this lands at ~1.25 B/sample where the best fixed width is 1.5.

("m", om, pm, wum, os, ps, wus) — mid/side rice (stereo only): the
FLAC m = (l+r)>>1, s = l-r transform first, then an INDEPENDENT
rice-coded plane each (own delta order, rice p, unary budget),
concatenated into the same 3-array payload shape as "r" so transfer
count per batch does not grow. On correlated stereo material the s
plane's delta entropy sits several bits below either raw channel's, so
this wire removes the inter-channel redundancy the joint-(L,R) rice
wire cannot see (measured on the bench corpus: 1.221 B/sample vs the
joint wire's 1.252; far larger gaps on real stereo recordings whose
channels share program material). Decode is two plane decodes + the
exact l = m + ((s + (s&1)) >> 1), r = l - s inversion.

("d", order) — delta16: the deltas shipped as PLAIN int16 — same
nominal bytes as raw PCM but far more transport-compressible (for
transports that compress payloads: tonal deltas are small-magnitude) at near-zero host CPU: two vectorized numpy diffs, no
scan, no bit packing, and NO fallback (wrapping int16 deltas
reconstruct exactly for bps <= 16 — mod-2^16 equality is equality when
the true sample fits int16).

`try_pack` chooses between the dense formats per batch: ONE fused C++
scan pass (`native.scan_wire`) measures the delta ranges and
per-rice-parameter cost sums together; the SMALLEST wire wins, with
raw fallback when nothing beats int16 (full-scale noise). The choice
among {raw, delta16, dense} belongs to the pipeline's per-format racer
(`models.batch_encoder.LinkEstimator`), which measures each format's
actual steady-state batch gap. Each wire tuple is one jit program
variant (the pipeline keeps rice Wu budgets sticky so variants stay
few); the numpy implementations here are the portable fallback and the
parity oracle for the C++ passes. On a host-local device the raw wire
is the default; these wires run only when asked for.
"""

from __future__ import annotations

from typing import Optional, Tuple

from . import jax_env  # noqa: F401

import jax.numpy as jnp
import numpy as np

# allowed field widths, narrowest first: 8-12 cover 16-bit material;
# 14-20 cover hi-res (bps <= 24) deltas, which would otherwise fall back
# to the raw int32 upload at 4 B/sample (width 16 is meaningful ONLY
# there — for bps <= 16 it would equal the raw int16 upload and the
# size comparison in try_pack rejects it)
WIDTHS = (8, 9, 10, 11, 12, 14, 16, 18, 20)
ORDERS = (1, 2)              # allowed delta orders
# sample-count divisibility for block sizes: even widths' bit-groups
# divide 16 samples, so T % 16 == 0 is the eligibility gate; the odd
# widths (9, 11) additionally require T % 32 == 0 and are skipped by
# scan() otherwise
GROUP = 16
# widest PCM the packed wires accept: deltas of bps-bit samples span
# bps+2 bits, and the rice zigzag must fit uint32 on both sides of the
# wire (26-bit deltas -> 27-bit z); the reference's own bps ceiling is
# 25 (verify.rs bps rule), so 24-bit input + the +1 side-channel bit
# stays in range while 32-bit raw int32 uploads stay raw
MAX_PACK_BPS = 24


def words_per_block(T: int, width: int) -> int:
    if T % GROUP != 0:
        raise ValueError(f"block size must be a multiple of {GROUP} (got {T})")
    return T * width // 32


def _deltas(x: np.ndarray, order: int) -> np.ndarray:
    """diff^order with the first `order` entries zeroed (wrapping int32)."""
    d = x.astype(np.int32)
    for _ in range(order):
        nxt = np.zeros_like(d)
        # numpy int32 subtraction wraps (C semantics) = the C++ pack and
        # the device's wrapping-int32 cumsum reconstruction exactly
        nxt[..., 1:] = d[..., 1:] - d[..., :-1]
        d = nxt
    d[..., :order] = 0
    return d


def width_from_minmax(lo1: int, hi1: int, lo2: int, hi2: int,
                      T: int) -> Optional[Tuple[int, int]]:
    """Narrowest fitting (order, width) from precomputed delta ranges
    (the selection rules of `scan`, applied to `native.scan_wire`'s
    min/max output); ties prefer lower order."""
    best = None
    for order, lo, hi in ((1, lo1, hi1), (2, lo2, hi2)):
        for w in WIDTHS:
            if (T * w) % 32 != 0:
                continue
            if lo >= -(1 << (w - 1)) and hi <= (1 << (w - 1)) - 1:
                if best is None or w < best[1]:
                    best = (order, w)
                break
    return best


def scan(chunk: np.ndarray) -> Optional[Tuple[int, int]]:
    """Narrowest fitting (order, width) for the batch, or None (use raw).

    numpy fallback / oracle for `native.scan_upload`; ties prefer lower
    order (one cumsum on device instead of two)."""
    x = chunk.astype(np.int32)
    if x.shape[-1] < 2:
        return None
    T = x.shape[-1]
    best = None
    for order in ORDERS:
        d = _deltas(x, order)
        lo, hi = (int(d.min()), int(d.max())) if d.size else (0, 0)
        for w in WIDTHS:
            if (T * w) % 32 != 0:
                continue
            if lo >= -(1 << (w - 1)) and hi <= (1 << (w - 1)) - 1:
                if best is None or w < best[1]:
                    best = (order, w)
                break
    return best


def pack(chunk: np.ndarray, order: int, width: int) -> Tuple[np.ndarray, np.ndarray]:
    """(..., T) int -> ((..., T*width/32) uint32 words, (..., 2) int32
    firsts). Field t occupies bits [t*width, (t+1)*width) of the row's
    little-endian bitstream. numpy fallback / oracle for
    `native.pack_upload`."""
    x = chunk.astype(np.int32)
    T = x.shape[-1]
    W = words_per_block(T, width)
    d = _deltas(x, order)
    u = d.astype(np.uint32) & np.uint32((1 << width) - 1)
    # expand each field to its bit positions via a (T*width, ) bit matrix:
    # vectorized as per-group word assembly (group = lcm(width,32)/width)
    G = np.lcm(width, 32) // width
    Wg = G * width // 32
    ug = u.reshape(u.shape[:-1] + (-1, G)).astype(np.uint64)
    words = np.zeros(ug.shape[:-1] + (Wg,), np.uint64)
    for j in range(G):
        bit = j * width
        k, off = bit // 32, bit % 32
        words[..., k] |= (ug[..., j] << off) & np.uint64(0xFFFFFFFF)
        if off + width > 32:
            words[..., k + 1] |= ug[..., j] >> (32 - off)
    words = words.astype(np.uint32).reshape(x.shape[:-1] + (W,))
    firsts = np.zeros(x.shape[:-1] + (2,), np.int32)
    firsts[..., 0] = x[..., 0]
    firsts[..., 1] = x[..., 1] if T > 1 else x[..., 0]
    return np.ascontiguousarray(words), firsts


# ---------------------------------------------------------------------------
# rice-coded wire ("r"): entropy coding for link-starved transports
# ---------------------------------------------------------------------------
#
# zigzag z of the order-`order` delta stream splits into a fixed p-bit
# low plane (same LSB-first field layout as the width format) and a
# unary quotient substream (q = z >> p encoded as q zeros then a one,
# LSB-first, zero-padded to a STATIC per-row word budget Wu). On the
# bench corpus this lands at ~1.19 B/sample where the best fixed width
# is 1.5 (and the transport compressor only gets that to ~1.40).
# Device decode needs no sequential bit cursor: the t-th sample's
# quotient is the count of zero bits between the (t-1)-th and t-th one
# bits, i.e. a cumsum + scatter-add over the (static) bit array.

_RICE_NP = 26   # candidate rice parameters 0..25 (24-bit deltas -> 27-bit z)
_RICE_ORDERS = 4  # delta orders 1..4 (FLAC's own fixed-predictor range)
_FIRSTS_BYTES = 8  # per-row int32 x2 (orders 1-2; orders 3-4 ship 4)


def firsts_width(order: int) -> int:
    """Per-row firsts lane count: orders 1-2 ship [x0, x1] (the original
    closed-form reconstruction contract); orders 3-4 ship the four
    difference warm-ups [x0, (Δx)[1], (Δ²x)[2], (Δ³x)[3]] consumed by
    the iterative cumsum reconstruction."""
    return 2 if order <= 2 else 4


def _warmups(x: np.ndarray, order: int) -> np.ndarray:
    """(..., 4) int32 difference warm-ups for orders 3-4: entry j is
    (Δ^j x)[j] — exactly the values the in-place backward differencing
    leaves below the order cutoff, and exactly what `_reconstruct`'s
    iterative cumsum needs to re-integrate level by level."""
    d = x.astype(np.int32)
    out = np.zeros(x.shape[:-1] + (4,), np.int32)
    out[..., 0] = d[..., 0]
    for j in range(1, 4):
        nxt = np.zeros_like(d)
        nxt[..., 1:] = d[..., 1:] - d[..., :-1]
        d = nxt
        out[..., j] = d[..., j] if d.shape[-1] > j else 0
    return out


def _wu_bucket(T: int) -> int:
    """Unary-budget rounding granularity (words): coarse enough that jit
    keys stay stable across batches, fine enough that the padding stays
    under ~1 bit/sample at any block size."""
    return max(16, T // 64)


def _zigzag(d: np.ndarray) -> np.ndarray:
    return ((d.astype(np.int64) << 1) ^ (d.astype(np.int64) >> 63)).astype(
        np.uint32
    )


def scan_rice_np(chunk: np.ndarray, orders: int = _RICE_ORDERS) -> np.ndarray:
    """numpy oracle for the native rice scans: (..., orders, 26) int64
    partial sums S[..., order-1, p] = sum_t(zigzag(delta_order)[t] >> p).
    Default covers orders 1-4; `native.scan_rice`'s 2-order layout is the
    [..., :2, :] prefix."""
    x = chunk.astype(np.int32)
    out = np.zeros(x.shape[:-1] + (orders, _RICE_NP), np.int64)
    for order in range(1, orders + 1):
        z = _zigzag(_deltas(x, order)).astype(np.int64)
        for p in range(_RICE_NP):
            out[..., order - 1, p] = (z >> p).sum(axis=-1)
    return out


def rice_plan(sums: np.ndarray, T: int, wu_margin: float = 1.0):
    """Chooses (order, p, Wu, wire_bytes) from scan_rice sums, or None.

    Exact accounting: lo plane rows*(T*p/32)*4 bytes + unary plane
    rows*Wu*4 (Wu = per-batch max row budget, bucketed for jit-key
    stability) + firsts. p respects the T*p %% 32 == 0 layout rule.
    `wu_margin` > 1 pads the unary budget when `sums` came from a
    SAMPLED scan (sampling noise on the max row; pack_rice still
    overflow-checks the exact stream)."""
    n_orders = sums.shape[-2]
    flat = sums.reshape(-1, n_orders, _RICE_NP)
    R = flat.shape[0]
    bucket = _wu_bucket(T)
    best = None
    for order in range(1, n_orders + 1):
        if order >= T:
            continue  # warm-ups would cover the whole block
        fb = firsts_width(order) * 4
        for p in range(_RICE_NP):
            if (T * p) % 32 != 0:
                continue
            row_bits = flat[:, order - 1, p] + T  # unary bits per row
            wu = int(-(-int(row_bits.max()) // 32))
            wu = -(-wu // bucket) * bucket
            # rank formats by their UNPADDED cost (the margin would skew
            # the choice toward large-p formats whose pad is smaller in
            # absolute terms); only the winner's shipped budget is padded
            nbytes = R * ((T * p // 32) * 4 + wu * 4 + fb)
            if best is None or nbytes < best[3]:
                best = (order, p, wu, nbytes)
    if best is not None and wu_margin > 1.0:
        order, p, wu, nbytes = best
        pad = int(-(-int(wu * wu_margin) // bucket)) * bucket
        best = (order, p, pad, R * ((T * p // 32) * 4 + pad * 4
                                    + firsts_width(order) * 4))
    return best


def pack_rice(chunk: np.ndarray, order: int, p: int, wu: int):
    """numpy oracle for `native.pack_rice`: (..., T) ->
    (lo (..., T*p/32) u32, unary (..., wu) u32,
    firsts (..., firsts_width(order)) i32);
    None if a row overflows the unary budget."""
    x = chunk.astype(np.int32)
    T = x.shape[-1]
    z = _zigzag(_deltas(x, order))
    q = (z >> p).astype(np.int64)
    ubits = q.sum(axis=-1) + T
    if ubits.max() > wu * 32:
        return None
    # low plane: same field layout as pack() but unsigned low bits of z
    if p:
        lo_src = z & np.uint32((1 << p) - 1)
        G = np.lcm(p, 32) // p
        Wg = G * p // 32
        ug = lo_src.reshape(x.shape[:-1] + (-1, G)).astype(np.uint64)
        words = np.zeros(ug.shape[:-1] + (Wg,), np.uint64)
        for j in range(G):
            bit = j * p
            k, off = bit // 32, bit % 32
            words[..., k] |= (ug[..., j] << off) & np.uint64(0xFFFFFFFF)
            if off + p > 32:
                words[..., k + 1] |= ug[..., j] >> (32 - off)
        lo = words.astype(np.uint32).reshape(x.shape[:-1] + (T * p // 32,))
    else:
        lo = np.zeros(x.shape[:-1] + (0,), np.uint32)
    # unary plane: terminator one-bit positions are prefix sums of (q+1);
    # LSB-first bit order, so little-endian packbits -> little-endian u32
    unary = np.zeros(x.shape[:-1] + (wu * 32,), np.uint8)
    term = np.cumsum(q + 1, axis=-1) - 1  # bit index of sample t's one
    np.put_along_axis(unary, term, 1, axis=-1)
    unary = (
        np.ascontiguousarray(np.packbits(unary, axis=-1, bitorder="little"))
        .view(np.uint32)
        .reshape(x.shape[:-1] + (wu,))
    )
    if order <= 2:
        firsts = np.zeros(x.shape[:-1] + (2,), np.int32)
        firsts[..., 0] = x[..., 0]
        firsts[..., 1] = x[..., 1] if T > 1 else x[..., 0]
    else:
        firsts = _warmups(x, order)
    return lo, unary, firsts


def ms_planes(chunk: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """FLAC mid/side transform of a (B, 2, T) stereo chunk (the same
    m = (l+r)>>1, s = l-r the encoder's stereo search uses,
    reference src/coding.rs:469-527): two CONTIGUOUS (B, T) int32
    planes, exactly invertible (l = m + ((s + (s&1)) >> 1), r = l - s).
    For correlated stereo material the s plane's delta entropy is far
    below either raw channel's, so rice-coding the planes separately
    beats the joint-(L, R) rice wire by the inter-channel redundancy."""
    l = chunk[:, 0].astype(np.int64)
    r = chunk[:, 1].astype(np.int64)
    m = np.ascontiguousarray(((l + r) >> 1).astype(np.int32))
    s = np.ascontiguousarray((l - r).astype(np.int32))
    return m, s


def plan_ms(sums_m: np.ndarray, sums_s: np.ndarray, T: int):
    """Per-plane rice plans from the planes' scan sums: (plan_m, plan_s,
    total_bytes) or None. Each plan is (order, p, Wu) chosen
    independently — the planes' statistics differ by design (that
    asymmetry is the whole win), so a shared p would sit between the
    two optima and forfeit most of it."""
    pm = rice_plan(sums_m, T)
    ps = rice_plan(sums_s, T)
    if pm is None or ps is None:
        return None
    return pm[:3], ps[:3], pm[3] + ps[3]


def _pk_for(order: int):
    """pack_rice implementation for this delta order: the C++ pass when
    the library carries the needed ABI (orders 3-4 need the rice4
    warm-up firsts layout), the numpy oracle otherwise."""
    from .. import native

    if native.available() and (order <= 2 or native.rice4_supported()):
        return native.pack_rice
    return pack_rice


def pack_ms(chunk: np.ndarray, om: int, pm: int, wum: int,
            os2: int, ps: int, wus: int, planes=None):
    """The ("m", om, pm, wum, os2, ps, wus) wire: mid/side transform,
    then an independent rice-coded plane each (reusing the "r" pack per
    plane), CONCATENATED into the same 3-array payload shape as the "r"
    wire — (lo (B, Lm+Ls) u32, unary (B, wum+wus) u32, firsts (B, 4)
    i32) — so payload arity (= transfer count per batch) does not grow.
    None if either plane overflows its unary budget. `planes` passes
    precomputed (m, s) to skip the transform."""
    m, s = ms_planes(chunk) if planes is None else planes
    a = _pk_for(om)(m, om, pm, wum)
    if a is None:
        return None
    b = _pk_for(os2)(s, os2, ps, wus)
    if b is None:
        return None
    lo = np.concatenate([a[0], b[0]], axis=-1)
    unary = np.concatenate([a[1], b[1]], axis=-1)
    firsts = np.concatenate([a[2], b[2]], axis=-1)
    return lo, unary, firsts


def pad_ms_unary(payload, wum: int, wus: int, fm: int, fs: int):
    """Re-pad a packed ms payload's unary planes to the sticky floors
    (fm >= wum, fs >= wus): zero padding past each plane's terminators
    is decode-inert (`unpack_rice` drops bits past the T-th one-bit)."""
    lo, unary, firsts = payload
    segs = [unary[..., :wum]]
    if fm > wum:
        segs.append(np.zeros(unary.shape[:-1] + (fm - wum,), np.uint32))
    segs.append(unary[..., wum:])
    if fs > wus:
        segs.append(np.zeros(unary.shape[:-1] + (fs - wus,), np.uint32))
    return lo, np.concatenate(segs, axis=-1), firsts


def _ms_plan_for(chunk: np.ndarray, bps: int):
    """Scan-only ms planning: ((m, s) planes, (plan_m, plan_s), bytes)
    or None when the chunk isn't eligible stereo."""
    from .. import native

    if (chunk.ndim != 3 or chunk.shape[1] != 2 or bps > MAX_PACK_BPS
            or chunk.shape[-1] < 2):
        return None
    T = chunk.shape[-1]
    planes = ms_planes(chunk)
    m, s = planes
    fm = native.scan_wire(m)
    if fm is not NotImplemented:
        sums_m = fm[0]
        sums_s = native.scan_wire(s)[0]
    else:
        sums_m = scan_rice_np(m)
        sums_s = scan_rice_np(s)
    plans = plan_ms(np.asarray(sums_m), np.asarray(sums_s), T)
    if plans is None:
        return None
    return planes, plans[:2], plans[2]


def pack_delta(chunk: np.ndarray, order: int = 2):
    """The ("d", order) wire: order-`order` wrapping deltas shipped as
    PLAIN int16 — same nominal bytes as raw PCM but far more
    transport-compressible (tonal material's deltas are small-magnitude,
    for transports that compress payloads), at near-zero
    host CPU (two vectorized numpy diffs; no scan, no bit packing, no
    fallback — wrapping int16 deltas reconstruct EXACTLY for bps <= 16
    because mod-2^16 equality is equality when the true x fits int16).
    Returns (wire, (deltas int16, firsts int32))."""
    # int16-storage chunks pass through without a copy (x is read-only
    # below: the delta chain always writes fresh arrays for order >= 1)
    x = np.asarray(chunk, dtype=np.int16)
    d = x
    for _ in range(order):
        nxt = np.zeros_like(d)
        nxt[..., 1:] = d[..., 1:] - d[..., :-1]  # int16 wraps (C semantics)
        d = nxt
    d[..., :order] = 0
    firsts = np.zeros(x.shape[:-1] + (2,), np.int32)
    firsts[..., 0] = x[..., 0]
    firsts[..., 1] = x[..., 1] if x.shape[-1] > 1 else x[..., 0]
    return ("d", order), (d, firsts)


def unpack_delta(d: jnp.ndarray, firsts: jnp.ndarray, T: int,
                 order: int) -> jnp.ndarray:
    """Device-side inverse of `pack_delta`: int32 reconstruction of the
    sign-extended wrapped int16 deltas is congruent to x mod 2^16, so a
    final wrap-to-int16 recovers x exactly (|x| < 2^15)."""
    v = _reconstruct(d.astype(jnp.int32), firsts, T, order)
    return ((v & jnp.int32(0xFFFF)) ^ jnp.int32(0x8000)) - jnp.int32(0x8000)


def try_pack(chunk: np.ndarray, bps: int = 16):
    """Adaptive one-call pack: (wire, payload) or None (upload raw).

    wire is ("w", order, width) or ("r", order, p, Wu); payload is the
    matching array tuple — (words, firsts) or (lo, unary, firsts). The
    SMALLEST wire wins: fixed width when the data is near-incompressible,
    rice when entropy coding pays (usually everything musical), raw when
    nothing beats the plain upload (int16 for bps <= 16, int32 above —
    hi-res content is where the wide widths 14-20 earn their keep).
    Fast path: ONE fused C++ scan pass (`native.scan_wire`) + C++ pack
    (GIL released); numpy oracle fallback otherwise."""
    from .. import native

    if bps > MAX_PACK_BPS:
        return None
    T = chunk.shape[-1]
    rows = chunk.size // T if T else 0
    if rows == 0 or T < 2:
        return None
    # NOTE: a sampled scan (scan_wire stride>1, ~2x cheaper host CPU) was
    # measured and REJECTED for this path: the unary-budget pad it needs
    # costs 3-12% wire bytes, and the rice wire is chosen precisely when
    # the link (not host CPU) is the bottleneck — exact sums keep the
    # wire minimal where it matters
    fused = native.scan_wire(chunk)
    use_native = fused is not NotImplemented
    if use_native:
        sums, mm = fused
        fmt = width_from_minmax(int(mm[0]), int(mm[1]), int(mm[2]),
                                int(mm[3]), T)
    else:
        fmt = scan(chunk)
        sums = scan_rice_np(chunk)
    raw_bytes = rows * T * (2 if bps <= 16 else 4)
    width_bytes = None
    if fmt is not None:
        order, width = fmt
        width_bytes = rows * ((T * width // 32) * 4 + _FIRSTS_BYTES)
        if width_bytes >= raw_bytes:
            # a wide field can lose to the plain upload (e.g. 16-bit
            # noise whose order-2 deltas need 18 bits)
            fmt = width_bytes = None
    rice = rice_plan(np.asarray(sums), T)
    if rice is not None and rice[3] >= raw_bytes:
        rice = None
    # mid/side candidate (stereo only): per-plane rice coding removes the
    # inter-channel redundancy the joint-(L,R) wire cannot see — on
    # correlated material the s plane's delta entropy is several bits
    # below either channel's. Costs one transform + one extra scan pass;
    # the pipeline's plan cache amortizes this across batches.
    ms = _ms_plan_for(chunk, bps)
    if ms is not None and ms[2] < min(
            x for x in (raw_bytes, width_bytes,
                        rice[3] if rice else None) if x is not None):
        planes, ((om, pm, wum), (os2, ps, wus)), _ = ms
        packed = pack_ms(chunk, om, pm, wum, os2, ps, wus, planes=planes)
        if packed is not None:
            return ("m", om, pm, wum, os2, ps, wus), packed
    if rice is not None and (width_bytes is None or rice[3] < width_bytes):
        r_order, p, wu, _ = rice
        packed = _pk_for(r_order)(chunk, r_order, p, wu)
        if packed is not None:
            return ("r", r_order, p, wu), packed
    if fmt is None:
        return None
    order, width = fmt
    packed = (
        native.pack_upload(chunk, order, width)
        if use_native else pack(chunk, order, width)
    )
    return ("w", order, width), packed


def _extract_fields(words: jnp.ndarray, T: int, width: int) -> jnp.ndarray:
    """LSB-first fixed-width field extraction: (..., T*width/32) u32 ->
    (..., T) u32 (static shifts, no gathers)."""
    G = int(np.lcm(width, 32)) // width
    Wg = G * width // 32
    g = words.reshape(words.shape[:-1] + (-1, Wg))
    m = jnp.uint32((1 << width) - 1)
    fields = []
    for j in range(G):
        bit = j * width
        k, off = bit // 32, bit % 32
        v = g[..., k] >> jnp.uint32(off) if off else g[..., k]
        if off + width > 32:
            v = v | (g[..., k + 1] << jnp.uint32(32 - off))
        fields.append(v & m)
    return jnp.stack(fields, axis=-1).reshape(words.shape[:-1] + (T,))


def _reconstruct(d: jnp.ndarray, firsts: jnp.ndarray, T: int,
                 order: int) -> jnp.ndarray:
    """Shared delta reconstruction: int32 cumsum(s); the order-2 closed
    form x[t] = x0 + t*(x1-x0) + cumsum(cumsum(d))[t] is exact in
    wrapping int32 arithmetic (the true x fits int32, so mod-2^32
    equality is equality). Orders 3-4 integrate level by level: the
    wire's firsts carry the difference warm-ups (Δ^j x)[j], each cumsum
    pass seeds slot j-1 with its warm-up and turns the Δ^j stream into
    the Δ^(j-1) stream — every step a wrapping int32 add, so exactness
    holds with no division (the binomial closed form would need /2, /6
    whose intermediates overflow int32)."""
    x0 = firsts[..., 0].astype(jnp.int32)[..., None]
    if order == 1:
        return x0 + jnp.cumsum(d, axis=-1)
    if order == 2:
        x1 = firsts[..., 1].astype(jnp.int32)[..., None]
        t = jnp.arange(T, dtype=jnp.int32)
        return (x0 + t * (x1 - x0)
                + jnp.cumsum(jnp.cumsum(d, axis=-1), axis=-1))
    y = d.astype(jnp.int32)
    for j in range(order, 0, -1):
        y = y.at[..., j - 1].set(firsts[..., j - 1].astype(jnp.int32))
        y = jnp.cumsum(y, axis=-1)
    return y


def unpack(words: jnp.ndarray, firsts: jnp.ndarray, T: int,
           order: int = 1, width: int = 12) -> jnp.ndarray:
    """Device-side inverse of `pack`: (..., W) uint32 -> (..., T) int32."""
    u = _extract_fields(words, T, width)
    sign = 1 << (width - 1)
    d = (u ^ jnp.uint32(sign)).astype(jnp.int32) - jnp.int32(sign)
    return _reconstruct(d, firsts, T, order)


def unpack_rice(lo: jnp.ndarray, unary: jnp.ndarray, firsts: jnp.ndarray,
                T: int, order: int, p: int) -> jnp.ndarray:
    """Device-side inverse of `pack_rice` — fully parallel unary decode.

    Sort-compaction: the position of sample t's terminator one-bit is the
    t-th smallest element of {j : bits[j]=1}, extracted with ONE stable
    sort per row (ones keyed by position, zeros pushed past the end), so
    q_t = pos_t - pos_{t-1} - 1 — static shapes, no sequential bit
    cursor (a scatter-add formulation is simpler; its speed on the GPU is
    not measured). Zero padding past the T-th terminator
    sorts to the dropped tail."""
    lead = unary.shape[:-1]
    Wu = unary.shape[-1]
    U = Wu * 32
    bits = (
        (unary[..., None] >> jnp.arange(32, dtype=jnp.uint32)) & jnp.uint32(1)
    ).astype(jnp.int32).reshape(lead + (U,))
    j = jnp.arange(U, dtype=jnp.int32)
    key = jnp.where(bits == 1, j, U + j)  # ones first, position order kept
    pos = jnp.sort(key, axis=-1)[..., :T]
    prev = jnp.concatenate(
        [jnp.full(lead + (1,), -1, jnp.int32), pos[..., :-1]], axis=-1
    )
    q = pos - prev - 1
    z = q.astype(jnp.uint32) << p
    if p:
        z = z | _extract_fields(lo, T, p)
    d = (z >> 1).astype(jnp.int32) ^ -(z & 1).astype(jnp.int32)
    return _reconstruct(d, firsts, T, order)


def unpack_ms(lo: jnp.ndarray, unary: jnp.ndarray, firsts: jnp.ndarray,
              T: int, om: int, pm: int, wum: int,
              os2: int, ps: int, wus: int) -> jnp.ndarray:
    """Device-side inverse of `pack_ms`: per-plane rice decode at STATIC
    slice boundaries (Lm = T*pm/32, wum from the wire tuple), then the
    exact FLAC mid/side inversion l = m + ((s + (s&1)) >> 1), r = l - s
    (l+r and l-r share parity, so (l+r)&1 == s&1 and the floor the
    forward (l+r)>>1 dropped is recoverable — component/decode.py uses
    the same identity). Returns (B, 2, T) int32."""
    Lm = T * pm // 32
    Fm = firsts_width(om)
    m = unpack_rice(lo[..., :Lm], unary[..., :wum], firsts[..., :Fm],
                    T, om, pm)
    s = unpack_rice(lo[..., Lm:], unary[..., wum:], firsts[..., Fm:],
                    T, os2, ps)
    l = m + ((s + (s & jnp.int32(1))) >> 1)
    return jnp.stack([l, l - s], axis=1)

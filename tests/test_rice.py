"""Unit tests for partitioned-Rice parameter search.

Goldens from ``/root/reference/src/rice.rs`` tests.
"""

import numpy as np
import pytest

from flacenc_tpu import sigen
from flacenc_tpu.ops import ref_np


def test_bit_table_initialization():
    # rice.rs:319-324
    table = ref_np.prc_bit_table(np.array([6, 8, 10, 12], dtype=np.uint32), 4)
    assert table[0] == 3 * 2 + 4 * 2 + 5 * 2 + 6 * 2 + 8
    assert table[1] == 3 + 4 + 5 + 6 + 8 + 4


def test_prc_parameter_search_reasonable():
    # rice.rs:326-339
    signal = sigen.Noise(0.25, seed0=11).to_vec_quantized(12, 64)
    z = ref_np.encode_signbit(signal)
    table = ref_np.prc_bit_table(z, 4)
    p, _bits = ref_np.table_minimizer(table, 14)
    assert 0 < p < 14


def test_finest_partition_order():
    # rice.rs:342-349
    assert ref_np.finest_partition_order(64, 4) == 4
    assert ref_np.finest_partition_order(64, 3) == 4
    assert ref_np.finest_partition_order(192, 1) == 6
    assert ref_np.finest_partition_order(192, 3) == 6
    assert ref_np.finest_partition_order(192, 4) == 5


def test_partitioned_rice_parameter_search():
    # rice.rs:352-365 structure: partitioned must beat single partition
    signal = np.concatenate(
        [
            sigen.Noise(0.5, seed0=0).to_vec_quantized(8, 64),
            sigen.Noise(0.05, seed0=1).to_vec_quantized(8, 64),
        ]
    )
    z = ref_np.encode_signbit(signal)
    _p, single_bits = ref_np.table_minimizer(ref_np.prc_bit_table(z[4:], 4), 14)
    prc = ref_np.find_partitioned_rice_parameter(signal, 4, 14)
    assert prc.code_bits <= single_bits
    assert prc.order == 1


def test_partition_evaluation():
    # rice.rs:368-378
    part1 = np.full(32, 0, dtype=np.uint32)
    part1[:5] = [17, 19, 15, 11, 19]
    part2 = np.full(32, 0, dtype=np.uint32)
    part2[:5] = [12, 14, 16, 18, 20]
    p1, b1 = ref_np.table_minimizer(part1, 4)
    p2, b2 = ref_np.table_minimizer(part2, 4)
    assert b1 + b2 == 23
    assert (p1, p2) == (3, 0)


def test_partition_merging():
    # rice.rs:381-391
    part1 = np.zeros(32, dtype=np.uint32)
    part1[:5] = [17, 19, 15, 11, 19]
    part2 = np.zeros(32, dtype=np.uint32)
    part2[:5] = [12, 14, 16, 18, 20]
    merged = ref_np.merge_tables(part1, part2)
    assert list(merged[:5]) == [25, 29, 27, 25, 35]


def test_minimizer_search():
    # rice.rs:394-412 incl. tie-breaking toward smaller p
    def bt(vals):
        t = np.zeros(32, dtype=np.uint32)
        t[: len(vals)] = vals
        return t

    assert ref_np.table_minimizer(bt([6, 7, 4, 5, 9, 0, 0, 0]), 4) == (2, 4)
    assert ref_np.table_minimizer(bt([6, 7, 8, 5, 3, 0, 0, 0]), 4) == (4, 3)
    assert ref_np.table_minimizer(bt([1, 7, 8, 5, 3, 0, 0, 0]), 4) == (0, 1)
    assert ref_np.table_minimizer(bt([7, 1, 1, 1, 3, 0, 0, 0]), 4) == (1, 1)


def test_prc_max_bits_saturation():
    # rice.rs:415-419
    table = ref_np.prc_bit_table(np.array([0x0FFF_FFFE, 0x0100_0000], np.uint32), 0)
    assert table[0] == ref_np.MAX_P_TO_BITS


def test_zigzag_roundtrip():
    v = np.array([0, -1, 1, -2, 2, 12345, -12345, -(1 << 31), (1 << 31) - 1], np.int32)
    z = ref_np.encode_signbit(v)
    assert list(z[:5]) == [0, 1, 2, 3, 4]
    assert np.array_equal(ref_np.decode_signbit(z), v)


def _xla_tables(errors, warmup, T):
    import jax
    import jax.numpy as jnp

    from flacenc_tpu.ops import rice as oR

    finest = oR.finest_partition_order(T, 64)
    fn = jax.jit(lambda e, w: oR._finest_tables(oR.encode_signbit(e), w, finest, T))
    return np.asarray(fn(jnp.asarray(errors), jnp.asarray(warmup))), finest


@pytest.mark.parametrize("kind", ["random", "saturating"])
def test_xla_rice_tables_match_reference(kind):
    """The device's finest-order cost tables (ops/rice._finest_tables) equal
    ref_np.prc_bit_table partition by partition at the device step's
    shape (B x 4 stereo candidates x 4096), including the warmup cut of
    partition 0 and the MAX_P_TO_BITS clamp on huge residuals."""
    rng = np.random.default_rng(0 if kind == "random" else 1)
    B, K, T = 2, 4, 4096
    if kind == "random":
        errors = rng.integers(-3000, 3000, (B, K, T)).astype(np.int32)
    else:
        # |e| = 2^27 in the first partitions: the per-partition sum passes
        # 2^31 and must clamp to MAX_P_TO_BITS, never wrap
        errors = rng.integers(-50, 50, (B, K, T)).astype(np.int32)
        errors[:, :, :96] = -(1 << 27)
        errors[:, 1, 200:260] = (1 << 30) - 1
    warmup = rng.integers(0, 12, (B, K)).astype(np.int32)
    got, finest = _xla_tables(errors, warmup, T)
    nparts = 1 << finest
    plen = T // nparts
    for b in range(B):
        for k in range(K):
            z = ref_np.encode_signbit(errors[b, k])
            for p in range(nparts):
                start = max(p * plen, int(warmup[b, k]))
                want = ref_np.prc_bit_table(z[start:(p + 1) * plen], 4)
                assert np.array_equal(got[b, k, p], want.astype(np.int64)), (b, k, p)
    if kind == "saturating":
        assert (got[:, :, 0, 0] == ref_np.MAX_P_TO_BITS).all()

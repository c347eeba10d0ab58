"""FLAC and encoder limit constants.

Mirrors the constant set of the reference encoder
(``/root/reference/src/constant.rs``) so that configs validate identically.
"""

from __future__ import annotations

# Default block size (constant.rs:32).
DEFAULT_BLOCK_SIZE = 4096

# The number of partitions used in the entropy-estimation order selector
# (constant.rs:35).
DEFAULT_ENTROPY_ESTIMATOR_PARTITIONS = 16
MAX_ENTROPY_ESTIMATOR_PARTITIONS = 64

# Bits-per-sample limits supported by the encoder (constant.rs:38,54).
MIN_BITS_PER_SAMPLE = 8
MAX_BITS_PER_SAMPLE = 24

# Block-size limits (constant.rs:45,57).
MIN_BLOCK_SIZE = 32
MAX_BLOCK_SIZE = 32767

# Blocks shorter than this are encoded as Constant/Verbatim only
# (constant.rs:51).
MIN_BLOCK_SIZE_FOR_PREDICTION = 64

# Maximum number of channels (constant.rs:60).
MAX_CHANNELS = 8

# Environment variable keys (constant.rs:87-90).
ENV_DEFAULT_PARALLELISM = "FLACENC_WORKERS"


class fixed:
    """Fixed-parameter LPC constants (constant.rs:93-96)."""

    MAX_LPC_ORDER = 4


class par:
    """Throughput-layer constants (constant.rs:99-104).

    ``FRAMEBUF_MULTIPLICITY`` maps to the number of in-flight host->device
    batches in the pipelined encoder. The reference double-buffers per
    worker thread; deeper pipelining hides each batch's upload, device
    step and decisions fetch behind the host work of the others. Override
    with FLACENC_PIPELINE_DEPTH.
    """

    import os as _os

    FRAMEBUF_MULTIPLICITY = int(_os.environ.get("FLACENC_PIPELINE_DEPTH", "8"))


class qlpc:
    """Quantized-LPC constants (constant.rs:107-135)."""

    DEFAULT_ORDER = 10
    DEFAULT_PRECISION = 15
    DEFAULT_TUKEY_ALPHA = 0.4
    MAX_ORDER = 24
    MAX_PRECISION = 15
    SHIFT_BITS = 5
    MAX_SHIFT = (1 << (SHIFT_BITS - 1)) - 1  # 15
    MIN_SHIFT = 0  # spec allows -16 but the reference decoder does not.


class rice:
    """Partitioned-Rice-coding constants (constant.rs:138-153)."""

    MAX_RICE_PARAMETER = 30
    MAX_PARTITION_ORDER = 15
    MAX_PARTITIONS = 1 << MAX_PARTITION_ORDER
    MIN_PARTITION_SIZE = 64


class build_info:
    """Build metadata (analogue of constant.rs:70-84)."""

    CRATE_VERSION = "0.5.3"
    BUILD_PROFILE = "release"
    FEATURES = "jax,native-packer"

"""flacenc_tpu — a FLAC encoder framework with a batched accelerator path.

Re-implements the capabilities of the `flacenc-rs` reference encoder
(layer map in SURVEY.md) with a batched JAX/XLA compute path and a C++
host-side bitstream packer. Public API mirrors the reference crate root
(``/root/reference/src/lib.rs:160-162``): `encode_with_fixed_block_size`
and `encode_fixed_size_frame`, plus the config/source/component modules.
"""

from . import bitio, component, config, constants, errors, sigen, source
from .errors import EncodeError, SourceError, Verified, VerifyError, into_verified

__version__ = constants.build_info.CRATE_VERSION


def encode_with_fixed_block_size(config, src, block_size, use_device=True,
                                 **kwargs):
    """Encode a `Source` into a `component.Stream` (main library entry).

    Dispatches to the batched device pipeline (the analogue of the
    reference's par-mode auto dispatch, coding.rs:650-654); runs the
    scalar numpy path when `use_device=False`. Extra
    keyword arguments (`batch_size`, `packer`, `strict_lpc`) are forwarded
    to the batched pipeline.
    """
    if use_device:
        from .models import batch_encoder

        return batch_encoder.encode_with_fixed_block_size(
            config, src, block_size, **kwargs
        )
    from .models import reference_encoder

    strict = kwargs.get("strict_lpc")
    explicit_strict = strict is True
    if strict is None:
        import os

        strict = os.environ.get("FLACENC_STRICT_LPC", "") == "1"
    cfg = config.inner if isinstance(config, Verified) else config
    if cfg.subframe_coding.qlpc.use_direct_mse:
        # same rule as the batched path (models/batch_encoder.py): strict
        # mode covers the autocorrelation method only — refuse an EXPLICIT
        # request instead of silently downgrading; env-derived strictness
        # falls back to the documented default semantics
        if explicit_strict:
            raise ValueError(
                "strict_lpc covers the autocorrelation method; the "
                "experimental direct-MSE/IRLS estimators have no strict "
                "float path"
            )
        strict = False
    return reference_encoder.encode_with_fixed_block_size(
        config, src, block_size, strict_lpc=strict
    )


def encode_fixed_size_frame(config, framebuf, frame_number, stream_info):
    """Encode a single `FrameBuf` into a `component.Frame`."""
    from .models import reference_encoder

    return reference_encoder.encode_fixed_size_frame(
        config, framebuf, frame_number, stream_info
    )


__all__ = [
    "bitio",
    "component",
    "config",
    "constants",
    "errors",
    "sigen",
    "source",
    "encode_with_fixed_block_size",
    "encode_fixed_size_frame",
    "EncodeError",
    "SourceError",
    "Verified",
    "VerifyError",
    "into_verified",
    "__version__",
]

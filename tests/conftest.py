"""Test configuration.

Tests run on a virtual 8-device CPU mesh: fast, deterministic, and
exercises the full multi-device sharding path without an accelerator.
Their compile cache has a fixed directory of its own, so CPU artifacts
never land where an accelerator run loads its cache. Tests that need a
card carry the `gpu` marker and skip here (see the `gpu_device`
fixture); `python chip_smoke.py` runs the same checks on the card.
"""

import os
import sys

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["JAX_COMPILATION_CACHE_DIR"] = os.path.join(_REPO, ".jax_cache_tests")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

sys.path.insert(0, _REPO)


import pytest  # noqa: E402


@pytest.fixture(autouse=True)
def _reset_cross_stream_ewma_seed():
    """Keep tests hermetic w.r.t. the process-wide fetch-EWMA seed
    (batch_encoder._LAST_FETCH_EWMA): production pipelines inherit the
    last stream's link measurement so short streams group immediately
    on slow links, but a test must not see grouping decisions driven by
    whichever test happened to run before it."""
    try:
        from flacenc_tpu.models import batch_encoder as _be

        _be._LAST_FETCH_EWMA = None
    except Exception:
        pass
    yield


@pytest.fixture
def gpu_device():
    """The first JAX device when it is a GPU; skips otherwise. Decided
    here, at run time, never at import or collection."""
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip("needs a GPU; run `python chip_smoke.py` on the card")
    return dev

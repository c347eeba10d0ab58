"""JAX environment setup for the device compute path.

f64 is required: the reference computes autocorrelation and Levinson in f64
(``/root/reference/src/lpc.rs:916``), and quantization must see the same
precision. Importing this module (done by every device op module) enables
x64 before any tracing happens.

Persistent compilation cache: encoder programs are specialized per
(config, block_size, batch) and reused across processes. When
``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and nothing is
configured here. Otherwise the cache lives at a fixed ``.jax_cache``
directory in the checkout (a fixed path: the path is part of the cache
key), which ``.gitignore`` lists.
"""

import os

import jax

jax.config.update("jax_enable_x64", True)

CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache",
)

if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
    jax.config.update("jax_compilation_cache_dir", CACHE_DIR)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)

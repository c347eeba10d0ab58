"""Builds the native shared libraries with g++.

Two deliberately SEPARATE libraries:
- ``libflacenc_packer.so`` (packer.cpp): the encoder-side bit packer and
  strict-float kernels.
- ``libflacenc_decoder.so`` (decoder.cpp): the clean-room independent
  decoder oracle, which must not link against (or share sources with)
  the packer so encoder bugs cannot cancel out in round-trip tests.

Each library is built with ``-march=native`` into
``_build/<key>/`` (listed in ``.gitignore``), where the key hashes the
source, the compile command and the host CPU's feature flags: a checkout
copied to another machine, or an edited source, finds no library under
its key and builds a fresh one instead of loading one made for another
ISA. Only the committed ``.cpp`` sources are inputs.

Run directly (``python flacenc_tpu/native/build.py``) or let
``flacenc_tpu.native`` auto-build on first import.
"""

from __future__ import annotations

import hashlib
import os
import platform
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(HERE, "_build")
SRC = os.path.join(HERE, "packer.cpp")
DEC_SRC = os.path.join(HERE, "decoder.cpp")
_FLAGS = [
    "-O3", "-march=native", "-shared", "-fPIC", "-std=c++17",
    "-fno-exceptions", "-fno-rtti", "-pthread",
]


def host_cpu_flags() -> str:
    """The host CPU's feature-flags line (what -march=native targets)."""
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith(("flags", "Features")):
                    return line.strip()
    except OSError:
        pass
    return f"{platform.machine()} {platform.processor()}"


def build_key(src: str) -> str:
    """Hash of the source bytes, the compile flags and the host CPU."""
    h = hashlib.sha256()
    with open(src, "rb") as f:
        h.update(f.read())
    h.update(" ".join(_FLAGS).encode())
    h.update(host_cpu_flags().encode())
    return h.hexdigest()[:16]


def _compile(src: str, name: str, force: bool) -> str:
    lib = os.path.join(BUILD_DIR, build_key(src), name)
    if not force and os.path.exists(lib):
        return lib
    os.makedirs(os.path.dirname(lib), exist_ok=True)
    # build to a private name, then rename: concurrent builders (test
    # workers) never load a half-written library
    tmp = f"{lib}.{os.getpid()}.tmp"
    subprocess.run(["g++", *_FLAGS, src, "-o", tmp], check=True)
    os.replace(tmp, lib)
    return lib


def build(force: bool = False) -> str:
    return _compile(SRC, "libflacenc_packer.so", force)


def build_decoder(force: bool = False) -> str:
    return _compile(DEC_SRC, "libflacenc_decoder.so", force)


if __name__ == "__main__":
    force = "--force" in sys.argv
    print(build(force=force))
    print(build_decoder(force=force))

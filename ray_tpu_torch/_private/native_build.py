"""Build and load the port's host C++ libraries (the port's counterpart of
``ray_tpu/_private/native_build.py``).

Each ``_private/native/<name>.cpp`` compiles with the host compiler
(``$CXX``, else ``g++``) into a shared library with a plain C interface,
loaded with :mod:`ctypes`: ``g++ -O2 -fPIC -shared -std=c++17 ... -lrt``,
JAX's command. A library lands in ``_private/native/build/`` (listed in
``.gitignore``) under a name that carries a hash of its source and the
flags, written to a temporary file and renamed into place, so processes
that build at once (test workers, the workers of a node) all load one
complete library and an edited source rebuilds at its next use, as the
CUDA kernels do (``ops/_build.py``). Nothing builds at import time.

A failed build raises with the compiler's output. There is no fallback:
JAX's ``RAY_TPU_DISABLE_NATIVE`` and its dict store are not carried over.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from typing import Dict

SRC_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "native")
BUILD_DIR = os.path.join(SRC_DIR, "build")
CXX_FLAGS = ["-O2", "-fPIC", "-shared", "-std=c++17", "-Wall"]
LIBS = ["-lrt"]
BUILD_TIMEOUT_S = 300.0

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}


def _cxx() -> str:
    for cand in (os.environ.get("CXX"), shutil.which("g++"),
                 shutil.which("c++")):
        if cand and shutil.which(cand):
            return shutil.which(cand)
    raise RuntimeError(
        "no host C++ compiler (set CXX or put g++ on PATH): the port's "
        "shared-memory object store is built from "
        "ray_tpu_torch/_private/native at first use")


def lib_path(src: str, build_dir: str = BUILD_DIR) -> str:
    """The library's path for the source at ``src``: a hash of its bytes
    and the flags."""
    h = hashlib.sha256()
    with open(src, "rb") as f:
        h.update(f.read())
    h.update(" ".join(CXX_FLAGS + LIBS).encode())
    name = os.path.splitext(os.path.basename(src))[0]
    return os.path.join(build_dir, f"lib{name}-{h.hexdigest()[:16]}.so")


def build(src: str, build_dir: str = BUILD_DIR) -> str:
    """Compile ``src`` unless its library exists; returns the library's
    path. Raises ``RuntimeError`` with the compiler's output when the
    build fails."""
    final = lib_path(src, build_dir)
    if os.path.exists(final):
        return final
    os.makedirs(build_dir, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so.tmp", dir=build_dir)
    os.close(fd)
    try:
        proc = subprocess.run([_cxx(), *CXX_FLAGS, "-o", tmp, src, *LIBS],
                              capture_output=True, text=True,
                              timeout=BUILD_TIMEOUT_S)
        if proc.returncode != 0:
            raise RuntimeError(
                f"building {src} failed (rc={proc.returncode}):\n"
                f"{(proc.stderr or proc.stdout)[-4000:]}")
        # Atomic publish: a concurrent build of the same hash wrote the
        # same bytes, and the last rename wins harmlessly.
        os.replace(tmp, final)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return final


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``_private/native/<name>.cpp``, built first
    when its current source has none."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            lib = _loaded[name] = ctypes.CDLL(
                build(os.path.join(SRC_DIR, name + ".cpp")))
        return lib

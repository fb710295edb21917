"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` into its own shared
library with a plain C interface, loaded with :mod:`ctypes` (no PyTorch
headers, so a build takes seconds). Libraries land in ``ops/build/``
(listed in ``.gitignore``) under a name that carries a hash of the
source, every shared header (``csrc/*.cuh``) and the flags, so an edited
source or header rebuilds at its next use.
Nothing is built at import time: the first call to :func:`load` builds
(or :func:`build_all` builds every source at once, one ``nvcc`` per
source, started together).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from typing import Dict, List

CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
BUILD_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_loaded: Dict[str, ctypes.CDLL] = {}


def sources() -> List[str]:
    """Kernel names: one per ``csrc/*.cu``."""
    return sorted(f[:-3] for f in os.listdir(CSRC) if f.endswith(".cu"))


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ([os.path.join(cuda_home, "bin", "nvcc")] if cuda_home
                 else []) + [shutil.which("nvcc") or "",
                             "/usr/local/cuda/bin/nvcc"]:
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME or put nvcc on PATH): the port's "
        "CUDA kernels are built from ray_tpu_torch/ops/csrc at first use")


def lib_path(name: str) -> str:
    """The library's path: a hash of its source, every ``csrc/*.cuh``
    (a source may include any of them) and the flags."""
    headers = sorted(f for f in os.listdir(CSRC) if f.endswith(".cuh"))
    h = hashlib.sha256()
    for f in [name + ".cu"] + headers:
        h.update(f.encode())
        with open(os.path.join(CSRC, f), "rb") as src:
            h.update(src.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"lib{name}-{h.hexdigest()[:16]}.so")


def _start(name: str):
    """Start ``nvcc`` for one source into a temp file beside its final
    path. Returns (process, tmp, final, log) or None when built."""
    final = lib_path(name)
    if os.path.exists(final):
        return None
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp,
           os.path.join(CSRC, name + ".cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, final, final[:-3] + ".log"


def _finish(name: str, started) -> None:
    proc, tmp, final, log = started
    out, _ = proc.communicate()
    with open(log, "w") as f:
        f.write(out)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed for {name}.cu "
                           f"(rc={proc.returncode}):\n{out[-4000:]}")
    # Atomic publish: a concurrent build of the same hash loses the race
    # harmlessly (both wrote identical bytes).
    os.replace(tmp, final)


def build_all() -> List[str]:
    """Build every kernel source at once (one ``nvcc`` each, started
    together) and wait for all of them. Returns the names built now."""
    started = {n: _start(n) for n in sources()}
    built = []
    errors = []
    for name, st in started.items():
        if st is None:
            continue
        try:
            _finish(name, st)
            built.append(name)
        except RuntimeError as e:
            errors.append(str(e))
    if errors:
        raise RuntimeError("\n".join(errors))
    return built


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built first if its
    current source has no library yet. A failed build raises."""
    lib = _loaded.get(name)
    if lib is not None:
        return lib
    st = _start(name)
    if st is not None:
        _finish(name, st)
    lib = ctypes.CDLL(lib_path(name))
    lib.ray_tpu_cuda_error_string.argtypes = [ctypes.c_int]
    lib.ray_tpu_cuda_error_string.restype = ctypes.c_char_p
    _loaded[name] = lib
    return lib


def error_string(lib: ctypes.CDLL, code: int) -> str:
    return lib.ray_tpu_cuda_error_string(code).decode()

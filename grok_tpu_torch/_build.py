"""Build and load the port's CUDA kernels.

Every `csrc/*.cu` source is compiled by `nvcc` for Hopper (sm_90a) into
one shared library with a plain C interface, loaded with ctypes.  The
build happens at first use — the first launch on a CUDA tensor — never
at import, into `_build/` beside this file (listed in .gitignore), keyed
on a hash of the sources and flags so a changed source rebuilds.  A
failed build raises with the compiler's output.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_HERE, "csrc")
BUILD_DIR = os.path.join(_HERE, "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
build_log: str = ""                    # nvcc's output (ptxas -v usage)


def _sources() -> list[str]:
    return sorted(glob.glob(os.path.join(CSRC, "*.cu"))
                  + glob.glob(os.path.join(CSRC, "*.cuh")))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for env in ("CUDA_HOME", "CUDA_PATH"):
        root = os.environ.get(env)
        if root and os.path.exists(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _digest(srcs: list[str]) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for s in srcs:
        h.update(os.path.basename(s).encode())
        with open(s, "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:16]


def load_library() -> ctypes.CDLL:
    """The kernels' shared library, built on first call."""
    global _lib, build_log
    with _lock:
        if _lib is not None:
            return _lib
        srcs = _sources()
        cu = [s for s in srcs if s.endswith(".cu")]
        so = os.path.join(BUILD_DIR, f"libgrok_kernels_{_digest(srcs)}.so")
        if not os.path.exists(so):
            os.makedirs(BUILD_DIR, exist_ok=True)
            tmp = f"{so}.{os.getpid()}.tmp"
            proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, *cu],
                                  capture_output=True, text=True)
            build_log = proc.stdout + proc.stderr
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed (exit {proc.returncode}):\n{build_log}")
            os.replace(tmp, so)
        lib = ctypes.CDLL(so)
        from grok_tpu_torch.ops import ht_decode
        ht_decode.bind(lib)
        _lib = lib
        return lib

"""Build and load the port's native libraries.

Shared libraries with plain C interfaces, loaded with ctypes:

  - the CUDA kernels: each `csrc/*.cu` source compiled by its own `nvcc`
    for Hopper (sm_90a) into its own library, all compilers started
    together, at the first launch on a CUDA tensor;
  - the host runtime: `csrc/host/*.c` (the C Tier-2 packet coder and
    the HT wire assembly and scan) compiled by the host C compiler, built
    at the first host call that needs it (native/__init__.py).

Nothing is built at import.  Builds go to `_build/` beside this file
(listed in .gitignore), keyed on a hash of the sources and flags so a
changed source rebuilds.  A build holds an exclusive lock on
`_build/.lock` (fcntl.flock) from the check for its output to the rename
of the finished file into place, so that processes starting cold
together (the workers of a distributed encode) build each library once:
the later ones wait, then load the first one's.  A failed build raises
with the compiler's output.
"""

from __future__ import annotations

import contextlib
import ctypes
import fcntl
import glob
import hashlib
import os
import shutil
import subprocess
import threading
import types

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_HERE, "csrc")
HOST_CSRC = os.path.join(CSRC, "host")
BUILD_DIR = os.path.join(_HERE, "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
CC_FLAGS = ["-O2", "-shared", "-fPIC"]

_lock = threading.Lock()
_libs: types.SimpleNamespace | None = None
_host_lib: ctypes.CDLL | None = None
build_log: str = ""                    # nvcc's output (ptxas -v usage)


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


def _digest(srcs: list[str], flags: list[str]) -> str:
    h = hashlib.sha256(" ".join(flags).encode())
    for s in srcs:
        h.update(os.path.basename(s).encode())
        with open(s, "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:16]


@contextlib.contextmanager
def _process_lock():
    """The build directory's lock, held across processes."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    with open(os.path.join(BUILD_DIR, ".lock"), "a") as f:
        fcntl.flock(f, fcntl.LOCK_EX)
        try:
            yield
        finally:
            fcntl.flock(f, fcntl.LOCK_UN)


def _start(cmd: list[str], so: str):
    """Start `cmd`, which writes to a temporary path appended to it."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{so}.{os.getpid()}.tmp"
    proc = subprocess.Popen([*cmd, "-o", tmp], stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, so


def _finish(job, what: str) -> str:
    """Wait for a started build and move its output into place (an atomic
    rename); returns the compiler's output."""
    proc, tmp, so = job
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"{what} failed (exit {proc.returncode}):\n{log}")
    os.replace(tmp, so)
    return log


def load_library() -> types.SimpleNamespace:
    """The kernels' libraries, one attribute per csrc/*.cu source
    (`.ht_decode`, `.ht_decode_v1`, `.ht_encode`, `.ht_encode_v1`,
    `.lane_gather`, `.lane_gather_v1`, `.t1_decode`, `.t1_decode_v1`,
    `.t1_encode`, `.t1_encode_v1`), built on first call."""
    global _libs, build_log
    with _lock:
        if _libs is not None:
            return _libs
        with _process_lock():
            headers = sorted(glob.glob(os.path.join(CSRC, "*.cuh")))
            targets, jobs = {}, []
            for src in sorted(glob.glob(os.path.join(CSRC, "*.cu"))):
                name = os.path.splitext(os.path.basename(src))[0]
                digest = _digest([src, *headers], NVCC_FLAGS)
                so = os.path.join(BUILD_DIR, f"lib{name}_{digest}.so")
                targets[name] = so
                if not os.path.exists(so):
                    jobs.append((name, _start([_nvcc(), *NVCC_FLAGS, src],
                                              so)))
            logs = [f"[{name}]\n{_finish(job, f'nvcc {name}.cu')}"
                    for name, job in jobs]
            build_log = "\n".join(logs)
            libs = types.SimpleNamespace(
                **{name: ctypes.CDLL(so) for name, so in targets.items()})
            from grok_tpu_torch.ops import (ht_decode, ht_encode,
                                            lane_gather, t1_decode,
                                            t1_encode)
            for mod in (ht_decode, ht_encode, lane_gather, t1_decode,
                        t1_encode):
                mod.bind(getattr(libs, mod.__name__.rsplit(".", 1)[1]))
            ht_decode.bind_v1(libs.ht_decode_v1)
            ht_encode.bind_v1(libs.ht_encode_v1)
            lane_gather.bind_v1(libs.lane_gather_v1)
            t1_decode.bind_v1(libs.t1_decode_v1)
            t1_encode.bind_v1(libs.t1_encode_v1)
            _libs = libs
            return libs


def load_host_library() -> ctypes.CDLL:
    """The host runtime's shared library, built on first call."""
    global _host_lib
    with _lock:
        if _host_lib is not None:
            return _host_lib
        with _process_lock():
            srcs = sorted(glob.glob(os.path.join(HOST_CSRC, "*.c")))
            so = os.path.join(BUILD_DIR,
                              f"libgrok_host_{_digest(srcs, CC_FLAGS)}.so")
            if not os.path.exists(so):
                cc = os.environ.get("CC") or shutil.which("cc") or "gcc"
                _finish(_start([cc, *CC_FLAGS, *srcs], so), "host C build")
            _host_lib = ctypes.CDLL(so)
            return _host_lib

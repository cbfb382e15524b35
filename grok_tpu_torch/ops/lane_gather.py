"""Per-lane gather: kernel P1 of the port.

out[r, l] = x[idx[r, l], l] for int32 (rows, L) tensors, which is
take_along_axis(x, idx, axis=0): the body of the Pallas probe in
tools/hw_validate.py `run_gather_probe` (a fixed L = 128 there; any
L >= 1 here).  The probe tested on the TPU whether a per-lane dynamic
gather could replace the T1 kernels' one-hot byte windows; in the port it
is a kernel of the hardware-validation tool (tools/hw_validate.py).

  - `lane_gather` is the wrapper: a CUDA tensor launches the
    hand-written kernel in csrc/lane_gather.cu (lane groups of 16 bytes,
    several rows a thread, x kept in L2 by an evict-last policy while idx
    and out stream past it), a CPU tensor runs `lane_gather_ref`.  There
    is no fallback from one to the other.
  - `lane_gather_v1` launches the first design, csrc/lane_gather_v1.cu
    (one thread per element): the oracle of the card's checks, on no
    other path.
  - `lane_gather_ref` is the plain PyTorch version, by advanced indexing.

An index outside [0, rows) gives 0 in all three.
"""

from __future__ import annotations

import ctypes

import torch

from grok_tpu_torch.ops.t1_decode import _check


def lane_gather_ref(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: x[idx[r, l], l] by advanced indexing, 0
    where idx[r, l] lies outside [0, rows)."""
    rows = x.shape[0]
    lanes = torch.arange(x.shape[1], device=x.device)
    ix = idx.to(torch.int64)
    inside = (ix >= 0) & (ix < rows)
    got = x[ix.clamp(0, rows - 1), lanes[None, :]]
    return torch.where(inside, got, torch.zeros_like(got))


def _checked(x: torch.Tensor, idx: torch.Tensor) -> torch.device:
    dev = x.device
    if x.dim() != 2 or x.shape[0] < 1 or x.shape[1] < 1:
        raise ValueError(f"x must be (rows, L) with rows, L >= 1, got "
                         f"{tuple(x.shape)}")
    _check("x", x, torch.int32, dev)
    _check("idx", idx, torch.int32, dev, tuple(x.shape))
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"no lane gather kernel for device {dev}")
    return dev


def _launch(fn, x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    out = torch.empty_like(x)
    rc = fn(x.data_ptr(), idx.data_ptr(), out.data_ptr(), x.shape[0],
            x.shape[1], torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"lane gather kernel launch failed: cudaError "
                           f"{rc}")
    return out


def lane_gather(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """out[r, l] = x[idx[r, l], l] for int32 (rows, L) x and idx on one
    device, rows >= 1, L >= 1; an index outside [0, rows) gives 0.  CPU
    tensors run the plain version; CUDA tensors launch the kernel, and
    anything the kernel does not take raises."""
    if _checked(x, idx).type == "cpu":
        return lane_gather_ref(x, idx)
    from grok_tpu_torch._build import load_library
    out = _launch(load_library().lane_gather.grk_lane_gather, x, idx)
    lane_gather.launches += 1
    return out


lane_gather.launches = 0


def lane_gather_v1(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """lane_gather through the first kernel design (csrc/
    lane_gather_v1.cu): the same arguments, checks and result."""
    if _checked(x, idx).type == "cpu":
        return lane_gather_ref(x, idx)
    from grok_tpu_torch._build import load_library
    out = _launch(load_library().lane_gather_v1.grk_lane_gather_v1, x, idx)
    lane_gather_v1.launches += 1
    return out


lane_gather_v1.launches = 0


def _declare(fn) -> None:
    vp = ctypes.c_void_p
    fn.argtypes = [vp, vp, vp, ctypes.c_longlong, ctypes.c_int, vp]
    fn.restype = ctypes.c_int


def bind(lib: ctypes.CDLL) -> None:
    """Declare the C entry point's signature on the loaded library."""
    _declare(lib.grk_lane_gather)


def bind_v1(lib: ctypes.CDLL) -> None:
    """The same for the first design's library."""
    _declare(lib.grk_lane_gather_v1)

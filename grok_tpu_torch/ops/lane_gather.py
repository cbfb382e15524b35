"""Per-lane gather: kernel P1 of the port.

out[r, l] = x[idx[r, l], l] for int32 (rows, L) tensors, which is
take_along_axis(x, idx, axis=0): the body of the Pallas probe in
tools/hw_validate.py `run_gather_probe` (a fixed L = 128 there; any
L >= 1 here).  The probe tested on the TPU whether a per-lane dynamic
gather could replace the T1 kernels' one-hot byte windows; in the port it
is a kernel of the hardware-validation tool (tools/hw_validate.py).

  - `lane_gather` is the wrapper: a CUDA tensor launches the
    hand-written kernel in csrc/lane_gather.cu (one thread per output
    element), a CPU tensor runs `lane_gather_ref`.  There is no fallback
    from one to the other.
  - `lane_gather_ref` is the plain PyTorch version, by advanced indexing.
"""

from __future__ import annotations

import ctypes

import torch

from grok_tpu_torch.ops.t1_decode import _check


def lane_gather_ref(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: x[idx[r, l], l] by advanced indexing."""
    lanes = torch.arange(x.shape[1], device=x.device)
    return x[idx.to(torch.int64), lanes[None, :]]


def lane_gather(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """out[r, l] = x[idx[r, l], l] for int32 (rows, L) x and idx on one
    device, rows >= 1, L >= 1 and 0 <= idx < rows.  CPU tensors run the
    plain version; CUDA tensors launch the kernel (an index out of range
    gives 0 there), and anything the kernel does not take raises."""
    dev = x.device
    if x.dim() != 2 or x.shape[0] < 1 or x.shape[1] < 1:
        raise ValueError(f"x must be (rows, L) with rows, L >= 1, got "
                         f"{tuple(x.shape)}")
    _check("x", x, torch.int32, dev)
    _check("idx", idx, torch.int32, dev, tuple(x.shape))
    if dev.type == "cpu":
        return lane_gather_ref(x, idx)
    if dev.type != "cuda":
        raise ValueError(f"no lane gather kernel for device {dev}")
    from grok_tpu_torch._build import load_library
    lib = load_library().lane_gather
    out = torch.empty_like(x)
    rc = lib.grk_lane_gather(x.data_ptr(), idx.data_ptr(), out.data_ptr(),
                             x.shape[0], x.shape[1],
                             torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"lane gather kernel launch failed: cudaError "
                           f"{rc}")
    lane_gather.launches += 1
    return out


lane_gather.launches = 0


def bind(lib: ctypes.CDLL) -> None:
    """Declare the C entry point's signature on the loaded library."""
    vp = ctypes.c_void_p
    fn = lib.grk_lane_gather
    fn.argtypes = [vp, vp, vp, ctypes.c_longlong, ctypes.c_int, vp]
    fn.restype = ctypes.c_int

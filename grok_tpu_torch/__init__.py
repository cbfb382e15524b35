"""grok_tpu_torch: the PyTorch/CUDA port of grok_tpu's device path.

It keeps its own copy of the host layers it needs (codestream, core,
Tier-2, the HT tables, the serving plans, and the C Tier-2 and HT wire
runtime) and ports what ran on the device: the serving and general decodes
and encodes, with the HT, Part-1 and P1 kernels hand-written in CUDA for
Hopper (csrc/), the top-level `compress` / `decompress` of grok_tpu
(subsampled components and per-component precision and signedness
included), the object API (codec.py Decompressor and Compressor) and the
CLI tools (cli/).  It imports
neither JAX nor the JAX package.  Importing the package builds nothing:
the first launch on a CUDA tensor builds the kernels, and the first host
call that needs the C runtime builds that (_build.py).
"""

from grok_tpu_torch.api import (HeaderInfo, compress,  # noqa: F401
                                compress_device, compress_device_batch,
                                decompress, decompress_device,
                                decompress_device_batch, read_header,
                                stage_device_batch)
from grok_tpu_torch.codec import Compressor, Decompressor  # noqa: F401
from grok_tpu_torch.core.image import (ColorSpace, Component,  # noqa: F401
                                       Image)
from grok_tpu_torch.core.params import (CompressParams,  # noqa: F401
                                        DecompressParams, MCTMode,
                                        ProgOrder)
from grok_tpu_torch.util.msg import set_msg_handlers  # noqa: F401


def initialize(num_threads: int | None = None) -> bool:
    """grk_initialize analog (grok_tpu.initialize): set the host threads
    of the port's CPU work (torch.set_num_threads; None or 0 leaves them
    as they are) and load the port's C host runtime, building it from
    the checkout at the first call.  Returns True when it loads."""
    import torch

    from grok_tpu_torch import native
    if num_threads:
        torch.set_num_threads(int(num_threads))
    try:
        native._lib()
    except (OSError, RuntimeError, FileNotFoundError):
        return False
    return True


def deinitialize() -> None:
    """grk_deinitialize analog (grok_tpu.deinitialize): the port holds no
    global state beyond the lazily loaded libraries; provided for API
    parity."""

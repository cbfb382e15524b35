"""grok_tpu_torch: the PyTorch/CUDA port of grok_tpu's device path.

It keeps its own copy of the host layers it needs (codestream, core,
Tier-2, the HT tables, the serving plans, and the C Tier-2 and HT wire
runtime) and ports what ran on the device: the batched HT serving decode
and encode, with the HT cleanup decoder (csrc/ht_decode.cu) and encoder
(csrc/ht_encode.cu) as hand-written CUDA kernels for Hopper.  It imports
neither JAX nor the JAX package.  Importing the package builds nothing:
the first launch on a CUDA tensor builds the kernels, and the first host
call that needs the C runtime builds that (_build.py).
"""

from grok_tpu_torch.api import (compress_device,  # noqa: F401
                                compress_device_batch, decompress_device,
                                decompress_device_batch, stage_device_batch)
from grok_tpu_torch.core.params import (CompressParams,  # noqa: F401
                                        DecompressParams)

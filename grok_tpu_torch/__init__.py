"""grok_tpu_torch: the PyTorch/CUDA port of grok_tpu's device path.

It keeps its own copy of the host layers it needs (codestream, core,
Tier-2, the HT tables, the serving plans, and the C Tier-2 and HT wire
runtime) and ports what ran on the device: the serving and general decodes
and encodes, with the HT, Part-1 and P1 kernels hand-written in CUDA for
Hopper (csrc/), the object API (codec.py Decompressor and Compressor)
and the CLI tools (cli/).  It imports
neither JAX nor the JAX package.  Importing the package builds nothing:
the first launch on a CUDA tensor builds the kernels, and the first host
call that needs the C runtime builds that (_build.py).
"""

from grok_tpu_torch.api import (HeaderInfo,  # noqa: F401
                                compress_device, compress_device_batch,
                                decompress_device, decompress_device_batch,
                                read_header, stage_device_batch)
from grok_tpu_torch.codec import Compressor, Decompressor  # noqa: F401
from grok_tpu_torch.core.image import Component, Image  # noqa: F401
from grok_tpu_torch.core.params import (CompressParams,  # noqa: F401
                                        DecompressParams)

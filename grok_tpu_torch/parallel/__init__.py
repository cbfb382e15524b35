"""Scale-out of the port: a device mesh driven by one process
(sharding.py) and tile-sharded encodes and decodes over processes
(distributed.py, imported by name)."""

from grok_tpu_torch.parallel.sharding import Mesh, tile_mesh

__all__ = ["Mesh", "tile_mesh"]

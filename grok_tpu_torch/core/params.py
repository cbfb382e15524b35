"""Compression / decompression parameter surfaces of the port.

The port's copy of grok_tpu/core/params.py, with the fields the port's
entry points read.  `mesh` is the counterpart of the JAX package's
execution switch of that name: a parallel/sharding.py Mesh of PyTorch
devices (one process drives them all) over which an encode shards its
forward DWT levels by rows and its default-style Part-1 lanes (K5), and
a decode its default-style Part-1 lanes (K3) and its synthesis levels;
its first device must be the entry point's device.  The host
post-processing options (`force_rgb`, `upsample`, `apply_icc`) apply
where the port returns a host Image (codec.py Decompressor.decompress,
the CLI tools; pipeline/postproc.py); the device entry points return the
decoded planes and ignore them.  The JAX package's other execution
switches (`backend`, `keep_device`) and its single-tile and
component-subset decodes (`tile_index`, `components`: the port decodes
one tile through codec.py Decompressor.decompress_tile) have no
counterpart: such a field is refused by the constructor (TypeError)
rather than ignored.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from enum import IntEnum


class ProgOrder(IntEnum):
    LRCP = 0
    RLCP = 1
    RPCL = 2
    PCRL = 3
    CPRL = 4


class MCTMode(IntEnum):
    NONE = 0
    RCT_OR_ICT = 1   # RCT when reversible, ICT when irreversible (Part 1)
    CUSTOM = 2       # custom matrix (Part 2 style)
    AUTO_RD = 3      # encode both ways and keep the R-D winner


# Code-block style bits (SPcod/SPcoc; ISO 15444-1 Table A.19)
CBLK_BYPASS = 0x01       # selective arithmetic coding bypass (lazy)
CBLK_RESET = 0x02        # reset context probabilities between passes
CBLK_TERMALL = 0x04      # terminate on each coding pass
CBLK_VSC = 0x08          # vertically stripe-causal context
CBLK_PTERM = 0x10        # predictable termination
CBLK_SEGSYM = 0x20       # segmentation symbols
CBLK_HT = 0x40           # HTJ2K (Part 15) block coder (SPcod/SPcoc bit 6)


class RsizProfile(IntEnum):
    NONE = 0x0000
    CINEMA_2K = 0x0003
    CINEMA_4K = 0x0004
    BROADCAST = 0x0100
    IMF = 0x0400
    PART15_HT = 0x4000    # HTJ2K capability (CAP marker present)


@dataclass
class Poc:
    """One progression-order change (POC marker entry)."""

    rs: int; cs: int; layer_end: int; re: int; ce: int; order: ProgOrder


@dataclass
class CompressParams:
    # tiling
    tile_w: int = 0             # 0 -> single tile over the whole image
    tile_h: int = 0
    tile_off_x: int = 0
    tile_off_y: int = 0
    # transform / coding
    num_resolutions: int = 6
    cblk_w_exp: int = 6         # 64
    cblk_h_exp: int = 6
    cblk_style: int = 0
    irreversible: bool = False  # False -> 5/3 + RCT, True -> 9/7 + ICT
    mct: MCTMode | None = None  # None -> auto (on iff >= 3 comps)
    custom_mct: object = None   # MCTMode.CUSTOM: the (C, C) forward matrix
    prog_order: ProgOrder = ProgOrder.LRCP
    prec_w_exps: list[int] = field(default_factory=list)   # per-resolution PPx
    prec_h_exps: list[int] = field(default_factory=list)
    pocs: list[Poc] = field(default_factory=list)
    # rate control
    num_layers: int = 1
    rates: list[float] = field(default_factory=list)       # compression ratios per layer
    quality: list[float] = field(default_factory=list)     # PSNR targets per layer
    fixed_quality: bool = False
    # quantization
    num_guard_bits: int = 2
    quant_step: float = 0.0     # 0 -> default derived steps
    quant_style_expounded: bool = True
    # ROI (Maxshift, RGN marker)
    roi_comp: int = -1
    roi_shift: int = 0
    roi_rect: tuple[int, int, int, int] | None = None
    # markers / framing
    sop: bool = False
    eph: bool = False
    write_tlm: bool = False
    write_plt: bool = False
    write_plm: bool = False
    write_ppm: bool = False
    comment: str | None = None
    rsiz: RsizProfile = RsizProfile.NONE
    frame_rate: float | None = None  # profile validation (Cinema/BC/IMF)
    mainlevel: int = 0               # Broadcast/IMF mainlevel
    sublevel: int = 0                # Broadcast sublevel (tiling rules)
    max_tile_parts: int = 1
    # HTJ2K
    ht: bool = False
    ht_planes: int = 0          # HT refinement passes below the cleanup
    ht_mixed: bool = False      # HT and Part-1 code-blocks mixed per block
    # container
    jp2: bool = False           # wrap codestream in JP2 boxes
    # parallel/sharding.py Mesh (axis "tiles"): shard the forward DWT
    # rows and the default-style Part-1 encode lanes over its devices;
    # the bytes equal the unsharded encode's
    mesh: object = None

    def validate(self):
        if not (1 <= self.num_resolutions <= 33):
            raise ValueError("num_resolutions must be in [1, 33]")
        if not (2 <= self.cblk_w_exp <= 10) or not (2 <= self.cblk_h_exp <= 10):
            raise ValueError("code-block exponents must be in [2, 10]")
        if self.cblk_w_exp + self.cblk_h_exp > 12:
            raise ValueError("code-block area must be <= 4096")
        if self.num_layers < 1:
            raise ValueError("need at least one layer")
        if self.rates and len(self.rates) != self.num_layers:
            raise ValueError("len(rates) must equal num_layers")
        if self.quality and len(self.quality) != self.num_layers:
            raise ValueError("len(quality) must equal num_layers")
        if self.prec_w_exps and len(self.prec_w_exps) < self.num_resolutions:
            raise ValueError("need a precinct exponent per resolution")
        if not (0 <= self.num_guard_bits <= 7):
            raise ValueError("guard bits must be in [0, 7]")
        if (self.ht or self.ht_mixed) and self.cblk_style & ~CBLK_HT:
            raise ValueError(
                "HTJ2K is a distinct block coder: Part-1 mode switches "
                "(BYPASS/RESET/TERMALL/VSC/PTERM/SEGSYM) do not apply")
        if self.ht_mixed and self.ht_planes:
            raise ValueError(
                "ht_mixed compares single-segment streams; the "
                "ht_planes refinement extension is HT-only")


@dataclass
class DecompressParams:
    reduce: int = 0                 # resolution reduction (discard levels)
    max_layers: int = 0             # 0 -> all layers
    window: tuple[int, int, int, int] | None = None   # canvas-coord region
    strict: bool | None = None      # None: the serving surfaces' default,
                                    # permissive (the C scan validates
                                    # framing, not per-pass payloads)
    mesh: object = None             # parallel/sharding.py Mesh: decode the
                                    # default-style Part-1 lanes and the
                                    # synthesis levels sharded over it
    force_rgb: bool = False         # host Image post-processing
    upsample: bool = False          # (pipeline/postproc.py)
    apply_icc: bool = False

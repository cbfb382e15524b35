"""Rsiz profile validation (Cinema / Broadcast / IMF).

The port's copy of grok_tpu/codestream/profiles.py: checks a
CompressParams + image geometry combination against the constraints the
profile imposes (ISO 15444-1 AMD-1/AMD-3/AMD-8 profiles: Cinema
frame-rate-dependent codestream byte ceilings, the DCI 1.302/2.604 Mb
per frame rule, Broadcast mainlevel bitrate ceilings and sublevel tiling
rules, the IMF mainlevel/sublevel grid with its sample-rate ceilings).
Returns a list of violation strings (empty = ok); the encode entry
points raise ValueError("profile violations: ...") on any.
"""

from __future__ import annotations

from grok_tpu_torch.core.params import CompressParams, ProgOrder, RsizProfile

# DCI: 250 Mb/s at 24 fps -> 1,302,083 bytes/frame max (500 Mb/s / 48fps
# stereoscopic uses the same per-frame cap); 2K@48 halves it
_CINEMA_FRAME_BYTES = {24: 1_302_083, 48: 651_041}

# Broadcast mainlevels (AMD-3 Table A.10-ish): max Msamples/s and Mb/s
_BC_MAINLEVELS = {
    0: (26, 200), 1: (65, 200), 2: (130, 200), 3: (195, 400),
    4: (260, 400), 5: (520, 800), 6: (1200, 1600), 7: (2400, 3200),
    8: (4800, 6400), 9: (9600, 12800), 10: (19200, 25600),
    11: (38400, 51200),
}

# IMF mainlevels (AMD-8): max Msamples/s
_IMF_MAINLEVELS = _BC_MAINLEVELS


def validate_profile(params: CompressParams, width: int, height: int,
                     numcomps: int, frame_rate: float | None = None,
                     mainlevel: int = 0, sublevel: int = 0) -> list[str]:
    errs: list[str] = []
    rsiz = params.rsiz
    if rsiz == RsizProfile.NONE:
        return errs

    if rsiz in (RsizProfile.CINEMA_2K, RsizProfile.CINEMA_4K):
        if not params.irreversible:
            errs.append("cinema profiles require the 9/7 transform")
        if params.tile_w or params.tile_h:
            errs.append("cinema profiles require a single untiled image")
        if (1 << params.cblk_w_exp) > 32 or (1 << params.cblk_h_exp) > 32:
            errs.append("cinema profiles require code-blocks <= 32x32")
        if params.prog_order != ProgOrder.CPRL:
            errs.append("cinema profiles require CPRL progression")
        if numcomps != 3:
            errs.append("cinema profiles require exactly 3 components")
        # precincts: 128 at the highest resolution, 256 below (DCI)
        if params.prec_w_exps:
            if params.prec_w_exps[-1] > 8 or any(
                    e > 8 for e in params.prec_w_exps[:-1]):
                errs.append("cinema precincts exceed 256 (128 at the "
                            "highest resolution)")
        if rsiz == RsizProfile.CINEMA_2K:
            if width > 2048 or height > 1080:
                errs.append("Cinema2K frame exceeds 2048x1080")
            if params.num_resolutions > 6:
                errs.append("Cinema2K allows at most 5 decomposition levels")
            fr = int(frame_rate or 24)
            cap = _CINEMA_FRAME_BYTES.get(fr)
            if cap is None:
                errs.append(f"Cinema2K frame rate {fr} not in (24, 48)")
            elif params.rates and params.rates[-1] > 1:
                frame_bytes = width * height * numcomps * 12 / 8 \
                    / params.rates[-1]
                if frame_bytes > cap:
                    errs.append(
                        f"Cinema2K rate exceeds the {cap}-byte frame "
                        f"ceiling at {fr} fps (requested ~{frame_bytes:.0f})")
        else:
            if width > 4096 or height > 2160:
                errs.append("Cinema4K frame exceeds 4096x2160")
            if params.num_resolutions > 7 or params.num_resolutions < 2:
                errs.append("Cinema4K requires 1..6 decomposition levels")
            if params.rates and params.rates[-1] > 1:
                frame_bytes = width * height * numcomps * 12 / 8 \
                    / params.rates[-1]
                if frame_bytes > _CINEMA_FRAME_BYTES[24]:
                    errs.append("Cinema4K rate exceeds the DCI frame "
                                "ceiling")

    elif rsiz == RsizProfile.BROADCAST:
        if mainlevel not in _BC_MAINLEVELS:
            errs.append(f"broadcast mainlevel {mainlevel} out of range")
        else:
            msamp, mbps = _BC_MAINLEVELS[mainlevel]
            fr = frame_rate or 30.0
            if width * height * numcomps * fr > msamp * 1e6:
                errs.append(
                    f"broadcast mainlevel {mainlevel} allows {msamp} "
                    "Msamples/s; frame geometry x rate exceeds it")
            if params.rates and params.rates[-1] > 1:
                bits = width * height * numcomps * 12 / params.rates[-1] * fr
                if bits > mbps * 1e6:
                    errs.append(
                        f"broadcast mainlevel {mainlevel} allows {mbps} "
                        "Mb/s; the requested rate exceeds it")
        if sublevel == 0:
            if params.tile_w or params.tile_h:
                errs.append("broadcast sublevel 0 forbids tiling")
        elif params.tile_w and (params.tile_w, params.tile_h) not in (
                (width, height), (1024, 1024), (2048, 2048)):
            errs.append("broadcast tiles must be untiled, 1024x1024 or "
                        "2048x2048")
        if params.prog_order not in (ProgOrder.CPRL,):
            errs.append("broadcast profiles require CPRL progression")
        if (1 << params.cblk_w_exp) > 128 or (1 << params.cblk_h_exp) > 128:
            errs.append("broadcast profiles require code-blocks <= 128x128")
        if params.num_resolutions > 6:
            errs.append("broadcast profiles allow at most 5 decomposition "
                        "levels")

    elif rsiz == RsizProfile.IMF:
        if (1 << params.cblk_w_exp) > 128 or (1 << params.cblk_h_exp) > 128:
            errs.append("IMF requires code-blocks <= 128x128")
        if params.num_layers != 1:
            errs.append("IMF requires exactly one quality layer")
        if params.prog_order != ProgOrder.CPRL:
            errs.append("IMF requires CPRL progression")
        if params.tile_w and (params.tile_w, params.tile_h) not in (
                (width, height), (1024, 1024), (2048, 2048)):
            errs.append("IMF tiles must be untiled, 1024x1024 or 2048x2048")
        if params.num_resolutions > 8:
            errs.append("IMF allows at most 7 decomposition levels")
        if mainlevel not in _IMF_MAINLEVELS:
            errs.append(f"IMF mainlevel {mainlevel} out of range")
        else:
            msamp, _ = _IMF_MAINLEVELS[mainlevel]
            fr = frame_rate or 24.0
            if width * height * numcomps * fr > msamp * 1e6:
                errs.append(
                    f"IMF mainlevel {mainlevel} allows {msamp} "
                    "Msamples/s; frame geometry x rate exceeds it")

    return errs

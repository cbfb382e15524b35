"""The giant tile over a device mesh, on the card(s):

    python -m grok_tpu_torch.tools.mesh_probe [side]

(G), one side x side 8-bit gray frame in one tile (8192 by default;
Part-1 lossless 5/3, 6 resolutions, 64x64 blocks), encoded and decoded
through compress_device / decompress_device unmeshed, over every visible
card (`tile_mesh()`, one shard a card: the halos peer to peer) and over
four virtual shards of card 0, a warm-up and 3 calls each (best and
median); the bytes must agree and each decode equal the source, with K5
and K3 launched once a shard and every decode served (the serving route,
which takes the mesh; the route is printed).  Then the finest synthesis
level the same three ways, and dryrun_multichip(4) on the visible
cards.  Prints the cards' names and power limits first; exits non-zero
where a result differs.

`giant_tile` and `finest_level` are the measurement itself; chip_smoke.py's
phase 27 calls them too, on one card.
"""

from __future__ import annotations

import contextlib
import sys
import time
from dataclasses import replace

import numpy as np
import torch

from grok_tpu_torch import _build, api
from grok_tpu_torch.core.geometry import Rect
from grok_tpu_torch.core.params import CompressParams, DecompressParams
from grok_tpu_torch.ops import dwt, t1_decode, t1_encode
from grok_tpu_torch.parallel import Mesh, sharding, tile_mesh
from grok_tpu_torch.parallel.entry import dryrun_multichip
from grok_tpu_torch.tools.hw_validate import card
from grok_tpu_torch.util.synth import synthetic_image

REPS = 3


def _timed(fn):
    """(fn(), wall seconds), every card synchronized before and after."""
    for d in range(torch.cuda.device_count()):
        torch.cuda.synchronize(d)
    t = time.perf_counter()
    out = fn()
    for d in range(torch.cuda.device_count()):
        torch.cuda.synchronize(d)
    return out, time.perf_counter() - t


def _best_median(ts: list) -> str:
    return (f"best {min(ts) * 1e3:.3f} ms, median "
            f"{float(np.median(ts)) * 1e3:.3f} ms of {len(ts)}")


@contextlib.contextmanager
def recorded(mod, fn_name: str, keep: int = 0):
    """mod.fn_name wrapped to count its calls (the sharded wrappers call
    their module's kernel wrapper once a shard; api.py's decode_tile, the
    tiles handed to the general route) and keep the arguments of the
    first `keep`.  Yields [calls so far, kept argument tuples].  A kernel
    wrapper counts its launches on the name it is bound to, so the spy
    carries the count while it stands in and hands it back."""
    rec = [0, []]
    real = getattr(mod, fn_name)

    def spy(*a, **k):
        rec[0] += 1
        if len(rec[1]) < keep:
            rec[1].append(a)
        return real(*a, **k)
    counted = hasattr(real, "launches")
    if counted:
        spy.launches = real.launches
    setattr(mod, fn_name, spy)
    try:
        yield rec
    finally:
        setattr(mod, fn_name, real)
        if counted:
            real.launches = spy.launches


def _check_launches(what: str, kern: str, rec: list, launched: int,
                    mesh, reps: int, device) -> None:
    """One launch a shard a call on the card.  On the CPU the wrappers run
    their plain versions, which count no launch: there the sharded
    route's wrapper calls are counted (the unsharded route calls the
    wrapper by its own module's name, which the spy does not replace)."""
    nsh = 1 if mesh is None else mesh.size
    want = nsh * (reps + 1)
    if torch.device(device).type == "cuda":
        got = launched
    elif mesh is not None:
        got = rec[0]
    else:
        return
    if got != want:
        raise RuntimeError(f"{what}: {got} {kern} launches in {reps + 1} "
                           f"calls, not {nsh} a call")


def giant_tile(name: str, src: torch.Tensor, params: CompressParams,
               meshes: dict, device, reps: int = REPS, tag: str = "",
               record: str | None = None) -> dict:
    """One frame `src` (on `device`) encoded and decoded over each mesh of
    `meshes` (name -> Mesh, or None for the unmeshed route; the first
    entry is the reference): a warm-up and `reps` calls of
    compress_device and of decompress_device each, printed with best and
    median and `tag`.  Each decode's route is printed: "served"
    (pipeline/serve.py, the mesh too) or "general" (pipeline/tile.py
    decode_tile).  Raises RuntimeError where the reps' bytes differ,
    where a mesh's bytes or planes differ from the reference's, where K5
    (encode) or K3 (decode) launched other than once a shard a call, or
    where a decode left the serving route.  record: a mesh whose K5 and
    K3 wrapper calls of the warm-up are kept (their argument tuples).

    Returns {mesh name: {"bytes", "planes", "enc_s", "dec_s", "route",
    "k5_calls", "k3_calls"}} (the times of the timed calls, in s)."""
    npx = src.shape[0] * src.shape[1]
    out, ref = {}, None
    for key, m in meshes.items():
        p = replace(params, mesh=m)
        nsh = 1 if m is None else m.size
        r = out[key] = {"enc_s": [], "dec_s": []}
        keep = nsh if key == record else 0
        k3_0 = t1_decode.t1_decode_lanes.launches
        with recorded(t1_encode, "t1_encode_lanes", keep) as k5:
            k5_0 = t1_encode.t1_encode_lanes.launches
            for i in range(reps + 1):
                data, dt = _timed(lambda: api.compress_device(
                    src, p, device=device))
                if i and data != r["bytes"]:
                    raise RuntimeError(f"encode {name} ({key}): reps gave "
                                       f"different bytes")
                r["bytes"] = data
                r["enc_s"].append(dt)
            k5_n = t1_encode.t1_encode_lanes.launches - k5_0
        k3_n = t1_decode.t1_decode_lanes.launches - k3_0
        r["k5_calls"] = k5[1]
        _check_launches(f"encode {name} ({key})", "K5", k5, k5_n, m, reps,
                        device)
        ts = r["enc_s"] = r["enc_s"][1:]
        print(f"encode {name} ({key}): {_best_median(ts)} calls, "
              f"{npx / 1e6 / min(ts):.2f} MP/s; {len(r['bytes'])} bytes; "
              f"K5 {k5_n} launches ({nsh} a call), K3 {k3_n} {tag}",
              flush=True)
        with recorded(t1_decode, "t1_decode_lanes", keep) as k3, \
                recorded(api, "decode_tile") as general:
            k3_0 = t1_decode.t1_decode_lanes.launches
            for _ in range(reps + 1):
                planes, dt = _timed(lambda: api.decompress_device(
                    r["bytes"], DecompressParams(mesh=m), device=device))
                r["planes"] = planes[0]
                r["dec_s"].append(dt)
            k3_n = t1_decode.t1_decode_lanes.launches - k3_0
        r["k3_calls"] = k3[1]
        r["route"] = "general" if general[0] else "served"
        _check_launches(f"decode {name} ({key})", "K3", k3, k3_n, m, reps,
                        device)
        ts = r["dec_s"] = r["dec_s"][1:]
        print(f"decode {name} ({key}): {_best_median(ts)} calls, "
              f"{npx / 1e6 / min(ts):.2f} MP/s; K3 {k3_n} launches ({nsh} a "
              f"call); route {r['route']} {tag}", flush=True)
        if general[0]:
            raise RuntimeError(f"decode {name} ({key}): {general[0]} tiles "
                               f"of {reps + 1} calls left the serving route")
        ref = ref or r
        if r["bytes"] != ref["bytes"]:
            raise RuntimeError(f"encode {name}: the bytes over {key} differ "
                               f"from the {next(iter(meshes))} encode's")
        if not torch.equal(r["planes"], ref["planes"]):
            raise RuntimeError(f"decode {name}: the planes over {key} "
                               f"differ from the {next(iter(meshes))} "
                               f"decode's")
    return out


def finest_level(src: torch.Tensor, meshes: dict, reps: int = REPS,
                 tag: str = "") -> dict:
    """The finest 5/3 synthesis level of `src` (a square or any (h, w)
    plane) unsharded (mesh None) and over each mesh, `reps` timed calls
    each, printed with best and median and `tag`; raises RuntimeError
    where a result differs from `src`.  Returns {mesh name: times, s}."""
    x = src.to(torch.int32)
    h, w = x.shape
    rect = Rect(0, 0, w, h)
    fine = dwt.fwd_2d_level(x, rect, False)
    out = {}
    for key, m in meshes.items():
        def level(m=m):
            if m is None:
                return dwt.inv_2d_level(*fine, rect, False)
            return sharding.inv_2d_level_sharded(*fine, rect, False, m)
        if not torch.equal(level(), x):
            raise RuntimeError(f"the synthesis level over {key} differs "
                               f"from the source")
        out[key] = [_timed(level)[1] for _ in range(reps)]
        print(f"synthesis level {h}x{w} ({key}): {_best_median(out[key])} "
              f"{tag}", flush=True)
    return out


def main(side: int = 8192) -> int:
    if not torch.cuda.is_available():
        print("mesh_probe: no CUDA card", file=sys.stderr)
        return 1
    tag = f"[{card()} x{torch.cuda.device_count()}]"
    print(tag, flush=True)
    _build.load_library()
    _build.load_host_library()
    dev = torch.device("cuda", 0)
    img = synthetic_image(side, side, 1, seed=27)
    src = torch.from_numpy(img).to(dev)
    meshes = {"unmeshed": None, "every card": tile_mesh(),
              "4 virtual shards": Mesh((dev,) * 4)}
    try:
        got = giant_tile("G", src, CompressParams(num_resolutions=6),
                         meshes, dev, tag=tag)
        if not np.array_equal(got["unmeshed"]["planes"].cpu().numpy(),
                              img):
            raise RuntimeError("decode G: the planes differ from the source")
        del got
        finest_level(src, meshes, tag=tag)
    except RuntimeError as e:
        print(f"mesh_probe: {e}", file=sys.stderr)
        return 1
    print(f"dryrun_multichip(4): {dryrun_multichip(4)}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(*(int(a) for a in sys.argv[1:2])))

"""Cached serving decode of HT streams on a PyTorch device.

The HT branch of grok_tpu/pipeline/serve.py `try_decode_serving_batch`:
the host work is the JAX package's own, shared rather than copied — the
cached ServePlan (`_plan_for`, whose cache `t1ht.tables.install_tables`
clears), the C Tier-2 parser and the C HT wire scan, which un-stuffs each
block's MagSgn stream into one digest.  The digest and one per-lane meta
array are uploaded from pinned host memory, and a DecodeProgram
(pipeline/device.py), cached on the plan, does the rest on the device.

Scope: single-tile HT streams, one cleanup segment per block, all
streams of a batch under one main header.  Anything else — Part-1/MQ,
HT mixed, windowed, layer-capped, strict, layered or refined HT, PPM/PPT,
per-component overrides, a mesh — raises NotImplementedError naming the
route: the port has no general path, and a quiet host decode would hide
the device.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from grok_tpu import native
from grok_tpu.pipeline.serve import _plan_for, _th_ovr_key
from grok_tpu.t1ht import tables
from grok_tpu_torch.ops.ht_decode import MAX_STREAM, _quant_len
from grok_tpu_torch.pipeline.device import META_COLS, Bucket, DecodeProgram


def _unsupported(route: str, why: str) -> NotImplementedError:
    return NotImplementedError(
        f"{route} is not ported ({why}); the PyTorch port serves "
        f"single-tile HT cleanup streams only")


@dataclass
class StagedBatch:
    """A batch ready on the device: run() decodes it."""
    program: DecodeProgram
    body: torch.Tensor        # uint8 digest
    meta: torch.Tensor        # (lanes, META_COLS) int32
    dims: list                # per bucket (Lms, Lsuf, Dm)

    def run(self) -> list:
        return self.program.run(self.body, self.meta, self.dims)


def _program(plan, N: int, device: torch.device) -> DecodeProgram:
    """DecodeProgram for (plan, N, device, table version), cached on the
    plan: under full staging every stream contributes every block the
    plan keeps, so the bucket layout depends on nothing else."""
    key = ("torch_prog", N, str(device), tables.VERSION)
    prog = plan.fast.get(key)
    if prog is None:
        fidx, bsel = _full_index(plan)
        buckets = tuple(
            Bucket(W, H, tuple(plan.sig_tail[gi] for gi in fidx[sel]))
            for (W, H), sel in zip(plan.bucket_dims, bsel) if sel.size)
        prog = DecodeProgram(plan.comps_sig, plan.mct_mode, N, buckets,
                             device)
        plan.fast[key] = prog
    return prog


def _full_index(plan):
    """(kept block indices, per-bucket positions into them)."""
    got = plan.fast.get("torch_full")
    if got is None:
        fidx = np.nonzero(plan.rok)[0]
        bsel = [np.nonzero(plan.bucket[fidx] == bid)[0]
                for bid in range(len(plan.bucket_dims))]
        got = (fidx, bsel)
        plan.fast["torch_full"] = got
    return got


def _upload(plan, arrays: list, device: torch.device) -> list:
    """Host numpy arrays -> device tensors, through one pinned staging
    buffer kept on the plan (reused once its previous copies are done)."""
    if device.type != "cuda":
        return [torch.from_numpy(a).to(device) for a in arrays]
    offs, total = [], 0
    for a in arrays:
        offs.append(total)
        total += -(-a.nbytes // 16) * 16
    key = ("torch_pinned", str(device))
    slot = plan.fast.get(key)
    if slot is None or slot[0].numel() < total:
        cap = -(-total // (1 << 20)) * (1 << 20)
        slot = [torch.empty(cap, dtype=torch.uint8, pin_memory=True), None]
        plan.fast[key] = slot
    buf, done = slot
    if done is not None:
        done.synchronize()
    host = buf.numpy()
    out = []
    for a, o in zip(arrays, offs):
        host[o:o + a.nbytes] = a.reshape(-1).view(np.uint8)
        t = buf[o:o + a.nbytes].view(torch.from_numpy(a[:0]).dtype)
        out.append(t.reshape(a.shape).to(device, non_blocking=True))
    slot[1] = torch.cuda.Event()
    slot[1].record()
    return out


def stage_serving_batch(cs: bytes, hdr, t: int, th, bodies: list, dp, *,
                        device, ths=None) -> StagedBatch:
    """Host staging of N same-geometry tile bodies and their upload."""
    device = torch.device(device)
    if dp.mesh is not None:
        raise _unsupported("sharded decode", "a mesh was given")
    if hdr.ppm is not None:
        raise _unsupported("general path", "PPM packed packet headers")
    if th.coc or th.qcc or th.rgn or th.pocs or th.ppt is not None:
        raise _unsupported("general path",
                           "per-component overrides, ROI, tile POC or PPT")
    if ths is not None and any(_th_ovr_key(q) != _th_ovr_key(th)
                               for q in ths):
        raise _unsupported("general path",
                           "batch streams with different tile overrides")
    if dp.window is not None:
        raise _unsupported("windowed serving", "a window was given")
    if dp.max_layers:
        raise _unsupported("layer-capped serving", "max_layers was given")
    if dp.strict:
        raise _unsupported("strict decode", "strict=True")
    plan = _plan_for(cs, hdr, t, th, int(dp.reduce or 0))
    if plan is None:
        raise _unsupported("general path", "the stream has no serving plan")
    if plan.coder == "mq":
        raise _unsupported("Part-1/MQ (mq3) route", "Part-1 code-blocks")
    if plan.coder != "ht" or any(
            q is not None and q.ht_mixed_bitmap() is not None
            for q in (ths or ())):
        raise _unsupported("HT mixed route", "an HT/MQ mixed stream")

    N = len(bodies)
    fidx, bsel = _full_index(plan)
    nf = fidx.size
    scans = np.zeros((N, nf, 7), np.int64)
    valid = np.zeros((N, nf), bool)
    digests = []
    for si, body in enumerate(bodies):
        parsed = native.t2_parse_prepared(body, plan.prep, plan.sop,
                                          plan.eph)
        if parsed is None:
            raise _unsupported("general path", f"stream {si}: T2 parse "
                               f"failed")
        incl, zb, npass, chunks, _end = parsed
        incl = np.asarray(incl, bool)
        if (chunks[:, 2] != 0).any():
            raise _unsupported("general path",
                               "multi-segment code-blocks")
        if len(chunks) != int(np.count_nonzero(incl)):
            raise _unsupported("layered HT serving", "more than one layer")
        offs = np.zeros(plan.n_blks, np.int64)
        lens = np.zeros(plan.n_blks, np.int32)
        offs[chunks[:, 0]] = chunks[:, 4]
        lens[chunks[:, 0]] = chunks[:, 5]
        idx = np.nonzero(incl & plan.rok)[0]
        if idx.size == 0:
            raise _unsupported("general path", f"stream {si}: no coded "
                               f"code-blocks")
        numbps = plan.mb[idx] - zb[idx]
        if not (npass[idx] == 1).all():
            raise _unsupported("HT refinement (K2) route",
                               "SigProp/MagRef passes")
        res = native.ht_scan2(body, offs[idx], lens[idx])
        if res is None:
            raise _unsupported("general path", "HT wire scan overflow")
        scan, dig = res
        if (scan[:, 0] < 0).any():
            raise _unsupported("general path", "invalid HT framing")
        # per-block cleanup plane (t1ht.scalar.derive_p: cleanup-only,
        # so p = 0 unless the ht_planes COM extension is present), kept
        # in scan column 0 (the validity flag)
        scan[:, 0] = np.minimum(plan.ht_p_ext, np.maximum(numbps - 1, 0))
        # the kernel's UVLC has no 13-bit escape: u <= numbps - p <= 24
        if ((numbps - scan[:, 0]) > 24).any():
            raise _unsupported("general path", "more than 24 magnitude "
                               "planes below the cleanup plane")
        if int(scan[:, 2:5:2].max()) > MAX_STREAM:
            raise _unsupported("general path", "a sub-stream longer than "
                               f"{MAX_STREAM} bytes")
        pos = np.searchsorted(fidx, idx)
        scans[si, pos] = scan
        valid[si, pos] = True
        digests.append(dig)

    # one digest for all streams, each at a 16-byte-aligned base
    bases = np.zeros(N, np.int64)
    pos = 0
    for si, d in enumerate(digests):
        bases[si] = pos
        pos += -(-len(d) // 16) * 16
    body_cat = np.zeros(max(16, pos), np.uint8)
    for b, d in zip(bases, digests):
        body_cat[b:b + len(d)] = d

    # full staging: a lane for every kept block of every stream (stream
    # major); blocks a stream does not include stay zero (valid = 0)
    prog = _program(plan, N, device)
    metas, dims = [], []
    for sel in bsel:
        if sel.size == 0:
            continue
        sc = scans[:, sel].reshape(-1, 7)
        v = valid[:, sel].reshape(-1)
        base = np.repeat(bases, sel.size)
        meta = np.zeros((sc.shape[0], META_COLS), np.int32)
        meta[:, 0] = np.where(v, sc[:, 1] + base, 0)
        meta[:, 1] = sc[:, 2]
        meta[:, 2] = np.where(v, sc[:, 3] + base, 0)
        meta[:, 3] = sc[:, 4]
        meta[:, 4] = sc[:, 0]
        meta[:, 5] = v
        # shift-candidate bound for the un-stuff: the bit deficit is <= 4
        # (VLC nibble) + stuffing deletions (the C scan's FF/0x7F counts)
        dmax = int(np.maximum(sc[:, 5], 4 + sc[:, 6]).max())
        need_d = -(-dmax // 8) + 1
        if need_d > 64:
            raise _unsupported("general path", "pathological stuffing "
                               "density")
        Dm = 1
        while Dm < need_d:
            Dm *= 2
        metas.append(meta)
        dims.append((_quant_len(int(sc[:, 2].max())),
                     _quant_len(int(sc[:, 4].max())), Dm))
    meta_all = np.concatenate(metas)
    body_d, meta_d = _upload(plan, [body_cat, meta_all], device)
    return StagedBatch(prog, body_d, meta_d, dims)


def try_decode_serving_batch(cs: bytes, hdr, t: int, th, bodies: list, dp,
                             *, device, ths=None) -> list:
    """Decode N same-geometry tile bodies on `device` -> N lists of
    per-component int32 tensors.  Raises NotImplementedError outside the
    served scope (the JAX counterpart returns None there and the caller
    falls back to its general path, which the port does not have)."""
    return stage_serving_batch(cs, hdr, t, th, bodies, dp, device=device,
                               ths=ths).run()

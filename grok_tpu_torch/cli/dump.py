"""grk_dump-parity CLI: print codestream structure (host only).

The port's copy of grok_tpu/cli/dump.py, on the port's own host layers;
the same flags and output:

    python -m grok_tpu_torch.cli.dump -i in.j2k [-v] [-j]

[grok: src/bin/jp2/GrkDump; upstream opj_dump_codec verified in SURVEY §1.1]
"""

from __future__ import annotations

import argparse
import sys

from grok_tpu_torch.codestream import j2k, jp2
from grok_tpu_torch.core.params import ProgOrder
from grok_tpu_torch.core.quant import (QSTYLE_DERIVED, QSTYLE_EXPOUNDED,
                                       QSTYLE_NONE)


def dump_codestream(data: bytes, out=None, verbose: bool = False):
    # the stream at call time (sys.stdout by default), so that a caller's
    # redirection of sys.stdout takes the text
    w = (out or sys.stdout).write
    if jp2.is_jp2(data):
        s, e, meta = jp2.parse_jp2(data)
        w("JP2 container:\n")
        w(f"  image {meta.width}x{meta.height}, {meta.numcomps} components\n")
        w(f"  color space: {meta.color_space.name}\n")
        if meta.icc_profile:
            w(f"  ICC profile: {len(meta.icc_profile)} bytes\n")
        if meta.palette:
            w(f"  palette: {len(meta.palette.entries)} entries x "
              f"{len(meta.palette.bit_depths)} channels\n")
        if meta.cdef:
            w(f"  channel definitions: {len(meta.cdef)}\n")
        if meta.capture_resolution:
            w(f"  capture resolution: {meta.capture_resolution}\n")
        cs = data[s:e]
    elif jp2.is_j2k(data):
        cs = data
    else:
        raise ValueError("not a JPEG 2000 stream")

    hdr = j2k.read_main_header(cs)
    g = hdr.siz.normalized()
    w("Main header:\n")
    w(f"  SIZ: image [{g.xosiz},{g.yosiz}]..[{g.xsiz},{g.ysiz}] "
      f"tiles {g.xtsiz}x{g.ytsiz} origin [{g.xtosiz},{g.ytosiz}] "
      f"({hdr.siz.num_tiles_x}x{hdr.siz.num_tiles_y} = "
      f"{hdr.siz.num_tiles} tiles)\n")
    w(f"  Rsiz: 0x{hdr.rsiz:04X}\n")
    for i, c in enumerate(hdr.comps):
        w(f"  comp[{i}]: prec={c.prec} sgnd={int(c.sgnd)} "
          f"dx={c.dx} dy={c.dy}\n")
    cod = hdr.cod
    w(f"  COD: prog={ProgOrder(cod.prog_order).name} layers={cod.num_layers}"
      f" mct={cod.mct} sop={int(cod.sop)} eph={int(cod.eph)}\n")
    cs_ = cod.comp
    w(f"       resolutions={cs_.num_resolutions} "
      f"cblk={1 << cs_.cblk_w_exp}x{1 << cs_.cblk_h_exp} "
      f"style=0x{cs_.cblk_style:02X} "
      f"transform={'9/7' if cs_.irreversible else '5/3'}\n")
    if cs_.prec_exps:
        w(f"       precincts={['%dx%d' % (1 << px, 1 << py) for (px, py) in cs_.prec_exps]}\n")
    for c, cc in sorted(hdr.coc.items()):
        w(f"  COC[{c}]: resolutions={cc.num_resolutions} "
          f"cblk={1 << cc.cblk_w_exp}x{1 << cc.cblk_h_exp}\n")
    qn = {QSTYLE_NONE: "reversible(none)", QSTYLE_DERIVED: "derived",
          QSTYLE_EXPOUNDED: "expounded"}
    w(f"  QCD: style={qn.get(hdr.qcd.style)} guard={hdr.qcd.guard_bits}\n")
    if verbose:
        for bi, s_ in enumerate(hdr.qcd.steps):
            w(f"       band[{bi}]: expn={s_.expn} mant={s_.mant}\n")
    for c, q in sorted(hdr.qcc.items()):
        w(f"  QCC[{c}]: style={qn.get(q.style)} guard={q.guard_bits}\n")
    for c, s_ in sorted(hdr.rgn.items()):
        w(f"  RGN[{c}]: shift={s_}\n")
    for p in hdr.pocs:
        w(f"  POC: r[{p.rs},{p.re}) c[{p.cs},{p.ce}) layers<{p.layer_end}"
          f" order={ProgOrder(p.order).name}\n")
    if hdr.cap:
        w(f"  CAP: Pcap=0x{hdr.cap[0]:08X} Scap={hdr.cap[1]}\n")
    for reg, com in hdr.comments:
        try:
            txt = com.decode("latin-1")
        except Exception:
            txt = repr(com)
        w(f"  COM ({'text' if reg == 1 else 'binary'}): {txt}\n")
    if hdr.tlm:
        w(f"  TLM: {len(hdr.tlm)} entries\n")
        if verbose:
            for (t, ln) in hdr.tlm:
                w(f"       tile {t}: {ln} bytes\n")

    parts = j2k.read_tile_parts(cs, hdr, strict=False)
    w(f"Tile parts: {len(parts)}\n")
    by_tile: dict[int, list] = {}
    for p in parts:
        by_tile.setdefault(p.tile_index, []).append(p)
        w(f"  tile {p.tile_index} part {p.part_index}/{p.num_parts}: "
          f"header@{p.header_start} data [{p.data_start},{p.data_end}) "
          f"({p.data_end - p.data_start} bytes)\n")
        if verbose:
            th = j2k.TileHeader()
            j2k.read_tile_part_header(cs, p, hdr, th)
            if th.plt:
                w(f"    PLT: {len(th.plt)} packet lengths "
                  f"(sum {sum(th.plt)})\n")
            if th.ppt is not None:
                w(f"    PPT: {len(th.ppt)} header bytes\n")
    if verbose:
        for t in sorted(by_tile):
            w(f"Packet index (tile {t}):\n")
            try:
                for (i, pc, off, ln) in tile_packet_index(cs, hdr,
                                                          by_tile[t], t):
                    w(f"  pkt {i}: L{pc.layer} r{pc.res} c{pc.comp} "
                      f"p{pc.prec} @ {off} ({ln} bytes)\n")
            except Exception as e:
                w(f"  <packet parse stopped: {type(e).__name__}>\n")


def tile_packet_index(cs: bytes, hdr, parts, t: int):
    """Walk one tile's packet sequence, yielding
    (index, PacketCoord, body_offset, length) — the reference's
    packet-index dump [grok: GrkDump packet listing]."""
    from grok_tpu_torch.codestream.bitio import BitReader
    from grok_tpu_torch.pipeline.tile import TileGeometry
    from grok_tpu_torch.t2.parse import EPH_MARKER, SOP_MARKER
    from grok_tpu_torch.t2.progression import iter_packets

    th = j2k.TileHeader()
    body = b""
    for p in sorted(parts, key=lambda p: p.part_index):
        j2k.read_tile_part_header(cs, p, hdr, th)
        body += cs[p.data_start:p.data_end]
    geo = TileGeometry.build(hdr, t, th)
    ctxs = geo.make_contexts()
    pos = 0
    pocs = (th.pocs or hdr.pocs) or None
    for i, pc in enumerate(iter_packets(
            geo.tcgs, geo.subsampling, geo.cod.num_layers,
            geo.cod.prog_order, geo.rect.x0, geo.rect.y0, pocs)):
        start = pos
        if geo.cod.sop and body[pos:pos + 2] == SOP_MARKER:
            pos += 6
        br = BitReader(body, pos)
        blen = ctxs[(pc.comp, pc.res, pc.prec)].decode_packet(
            br, pc.layer, 0)
        pos = br.pos
        if geo.cod.eph and body[pos:pos + 2] == EPH_MARKER:
            pos += 2
        pos += blen
        if pos > len(body):
            break
        yield i, pc, start, pos - start


def dump_json(data: bytes) -> dict:
    """Machine-readable structure dump (grk_dump's raw/json analog)."""
    doc: dict = {}
    if jp2.is_jp2(data):
        s, e, meta = jp2.parse_jp2(data)
        doc["container"] = {
            "format": "jp2",
            "width": meta.width, "height": meta.height,
            "numcomps": meta.numcomps,
            "color_space": meta.color_space.name,
            "icc_profile_bytes": len(meta.icc_profile or b""),
            "palette_entries": len(meta.palette.entries)
            if meta.palette else 0,
            "cdef": [{"channel": c.channel, "typ": c.typ, "assoc": c.assoc}
                     for c in meta.cdef],
            "capture_resolution": meta.capture_resolution,
        }
        cs = data[s:e]
    elif jp2.is_j2k(data):
        doc["container"] = {"format": "j2k"}
        cs = data
    else:
        raise ValueError("not a JPEG 2000 stream")

    hdr = j2k.read_main_header(cs)
    g = hdr.siz.normalized()
    qn = {QSTYLE_NONE: "none", QSTYLE_DERIVED: "derived",
          QSTYLE_EXPOUNDED: "expounded"}
    cs_ = hdr.cod.comp
    doc["siz"] = {
        "image": [g.xosiz, g.yosiz, g.xsiz, g.ysiz],
        "tile": [g.xtosiz, g.ytosiz, g.xtsiz, g.ytsiz],
        "num_tiles": [hdr.siz.num_tiles_x, hdr.siz.num_tiles_y],
        "rsiz": hdr.rsiz,
        "components": [{"prec": c.prec, "sgnd": c.sgnd,
                        "dx": c.dx, "dy": c.dy} for c in hdr.comps],
    }
    doc["cod"] = {
        "prog_order": ProgOrder(hdr.cod.prog_order).name,
        "num_layers": hdr.cod.num_layers, "mct": hdr.cod.mct,
        "sop": hdr.cod.sop, "eph": hdr.cod.eph,
        "num_resolutions": cs_.num_resolutions,
        "cblk": [1 << cs_.cblk_w_exp, 1 << cs_.cblk_h_exp],
        "cblk_style": cs_.cblk_style,
        "transform": "9/7" if cs_.irreversible else "5/3",
        "precincts": [[1 << px, 1 << py] for (px, py) in cs_.prec_exps]
        if cs_.prec_exps else None,
    }
    doc["coc"] = {c: {"num_resolutions": cc.num_resolutions,
                      "cblk": [1 << cc.cblk_w_exp, 1 << cc.cblk_h_exp]}
                  for c, cc in sorted(hdr.coc.items())}
    doc["qcd"] = {"style": qn.get(hdr.qcd.style), "guard": hdr.qcd.guard_bits,
                  "steps": [{"expn": s_.expn, "mant": s_.mant}
                            for s_ in hdr.qcd.steps]}
    doc["qcc"] = {c: {"style": qn.get(q.style), "guard": q.guard_bits}
                  for c, q in sorted(hdr.qcc.items())}
    doc["rgn"] = dict(sorted(hdr.rgn.items()))
    doc["pocs"] = [{"rs": p.rs, "re": p.re, "cs": p.cs, "ce": p.ce,
                    "layer_end": p.layer_end,
                    "order": ProgOrder(p.order).name} for p in hdr.pocs]
    if hdr.cap:
        doc["cap"] = {"pcap": hdr.cap[0], "scap": list(hdr.cap[1])}
    doc["comments"] = [{"registration": reg,
                        "text": com.decode("latin-1", "replace")}
                       for reg, com in hdr.comments]
    if hdr.tlm:
        doc["tlm"] = [{"tile": t, "bytes": ln} for t, ln in hdr.tlm]
    if hdr.plm:
        doc["plm"] = [{"tile_part": i, "num_packets": len(lens),
                       "sum": sum(lens)} for i, lens in enumerate(hdr.plm)]
    if hdr.crg:
        doc["crg"] = [{"xcrg": x, "ycrg": y} for (x, y) in hdr.crg]

    parts = j2k.read_tile_parts(cs, hdr, strict=False)
    doc["tile_parts"] = []
    for p in parts:
        ent = {"tile": p.tile_index, "part": p.part_index,
               "num_parts": p.num_parts, "header_start": p.header_start,
               "data_start": p.data_start, "data_end": p.data_end}
        th = j2k.TileHeader()
        try:
            j2k.read_tile_part_header(cs, p, hdr, th)
            if th.plt:
                ent["plt"] = {"num_packets": len(th.plt),
                              "sum": sum(th.plt)}
            if th.ppt is not None:
                ent["ppt_bytes"] = len(th.ppt)
        except Exception:
            pass
        doc["tile_parts"].append(ent)
    return doc


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="grk_dump")
    p.add_argument("-i", "--in-file", required=True)
    p.add_argument("-v", "--verbose", action="store_true")
    p.add_argument("-j", "--json", action="store_true",
                   help="machine-readable JSON output")
    a = p.parse_args(argv)
    with open(a.in_file, "rb") as f:
        data = f.read()
    try:
        if a.json:
            import json
            json.dump(dump_json(data), sys.stdout, indent=2)
            sys.stdout.write("\n")
        else:
            dump_codestream(data, verbose=a.verbose)
    except BrokenPipeError:
        return 0
    except ValueError as e:
        print(f"grk_dump: {a.in_file}: {e}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())

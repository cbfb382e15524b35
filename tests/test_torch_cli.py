"""The port's CLI tools (grok_tpu_torch/cli: compress, decompress, dump),
run with --device cpu through main(argv), against the JAX package's tools
(grok_tpu/cli) on the same files: every output file equal byte for byte
(reversible encodes; decodes of the same streams), and the dump's text
and JSON equal."""

import contextlib
import io
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from grok_tpu import native  # noqa: E402
from grok_tpu.cli import compress as jcompress  # noqa: E402
from grok_tpu.cli import decompress as jdecompress  # noqa: E402
from grok_tpu.cli import dump as jdump  # noqa: E402
from grok_tpu.util.oracle import synthetic_image  # noqa: E402
from grok_tpu_torch.cli import compress as pcompress  # noqa: E402
from grok_tpu_torch.cli import decompress as pdecompress  # noqa: E402
from grok_tpu_torch.cli import dump as pdump  # noqa: E402

pytestmark = pytest.mark.skipif(not native.available(),
                                reason="no C toolchain")

CPU = ["--device", "cpu"]
SMALL = ["-n", "3", "-b", "16,16"]


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("cli")
    rgb = synthetic_image(40, 48, 3, seed=11).astype(np.uint8)
    ppm = d / "in.ppm"
    ppm.write_bytes(b"P6\n48 40\n255\n" + rgb.tobytes())
    deep = np.random.default_rng(12).integers(0, 1 << 24, (24, 32))
    pgx = d / "in.pgx"
    pgx.write_bytes(b"PG ML +24 32 24\n" + deep.astype(">u4").tobytes())
    return d, rgb, deep


def _run(main, argv) -> str:
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert main(argv) == 0
    return out.getvalue()


ENCODES = [("in.ppm", "ht.j2k", ["-HT"]),
           ("in.ppm", "p1.jp2", []),
           ("in.ppm", "tiled.j2k", ["-HT", "-t", "32,32", "-TLM", "-PLT"]),
           ("in.ppm", "lay.j2k", ["-HT", "-r", "20,5,1", "-C", "cli"]),
           ("in.pgx", "deep.j2k", ["-HT"]),
           ("in.pgx", "deep.jp2", ["-G", "3"])]


@pytest.fixture(scope="module")
def encoded(files):
    d = files[0]
    for src, name, flags in ENCODES:
        argv = ["-i", str(d / src), "-o", str(d / ("p_" + name))] + SMALL \
            + flags
        assert pcompress.main(argv + CPU) == 0
        jargv = argv[:3] + [str(d / ("j_" + name))] + argv[4:]
        assert jcompress.main(jargv) == 0
    return d


@pytest.mark.parametrize("name", [e[1] for e in ENCODES])
def test_compress_writes_the_jax_tools_file(encoded, name):
    d = encoded
    assert (d / ("p_" + name)).read_bytes() == \
        (d / ("j_" + name)).read_bytes()


DECODES = [("ht.j2k", "out.ppm", []),
           ("p1.jp2", "out.ppm", ["-r", "1"]),
           ("tiled.j2k", "win.ppm", ["-d", "5,7,41,30"]),
           ("tiled.j2k", "t3.ppm", ["-T", "3"]),
           ("lay.j2k", "c1.pgx", ["-c", "1", "-l", "2"]),
           ("ht.j2k", "p12.pam", ["-p", "12"]),
           ("deep.j2k", "out.pgx", []),
           ("deep.jp2", "out.pgx", [])]


@pytest.mark.parametrize("src, out, flags", DECODES,
                         ids=[f"{s}-{o}-{'_'.join(f)}" for s, o, f in
                              DECODES])
def test_decompress_writes_the_jax_tools_file(encoded, src, out, flags):
    d = encoded
    stem = src.replace(".", "_") + "_" + "_".join(flags) + "_"
    p, j = d / (stem + "p_" + out), d / (stem + "j_" + out)
    argv = ["-i", str(d / ("j_" + src))] + flags
    assert pdecompress.main(argv + ["-o", str(p)] + CPU) == 0
    assert jdecompress.main(argv + ["-o", str(j)]) == 0
    assert p.read_bytes() == j.read_bytes()


def test_round_trips_are_exact(encoded, files):
    d, rgb, deep = files
    assert (d / "ht_j2k__p_out.ppm").read_bytes()[-rgb.nbytes:] == \
        rgb.tobytes()
    got = np.frombuffer((d / "deep_j2k__p_out.pgx").read_bytes()[-deep.size
                                                                * 4:], ">u4")
    assert np.array_equal(got.reshape(deep.shape), deep)


def test_decompress_trace_writes_a_perfetto_file(encoded, monkeypatch):
    """--trace writes the CLI's spans and the decode's (a permissive HT
    decode: the serving route), each decode span with its parent and the
    call id of the CLI span that encloses it."""
    from grok_tpu_torch.util import trace
    monkeypatch.setattr(trace, "_enabled", False)
    d = encoded
    tr = d / "trace.json"
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        assert pdecompress.main(["-i", str(d / "j_ht.j2k"), "-o",
                                 str(d / "tr.ppm"), "-f", "--trace",
                                 str(tr)] + CPU) == 0
    events = json.loads(tr.read_text())["traceEvents"]
    names = {e["name"] for e in events}
    assert {"decompress", "write_image", "decode.stage.t2",
            "decode.stage.pack", "decode.stage.upload", "decode.program",
            "decode.program.synth"} <= names
    by_id = {e["args"]["id"]: e for e in events}
    root = next(e for e in events if e["name"] == "decompress")
    assert root["args"]["parent"] is None
    for e in events:
        if e["name"].startswith("decode."):
            assert e["args"]["call"] == root["args"]["id"]
            up = by_id[e["args"]["parent"]]
            assert up["ts"] <= e["ts"] and \
                e["ts"] + e["dur"] <= up["ts"] + up["dur"] + 1e-3
    assert by_id[next(e for e in events if e["name"] ==
                      "decode.stage.upload")["args"]["parent"]]["name"] \
        == "decode.stage.pack"
    stages = json.loads(err.getvalue().splitlines()[-1])["stages"]
    assert stages["decode.program"]["self_s"] <= \
        stages["decode.program"]["total_s"]


@pytest.mark.parametrize("flags", [[], ["-v"], ["-j"]])
@pytest.mark.parametrize("src", ["j_tiled.j2k", "j_deep.jp2"])
def test_dump_prints_what_the_jax_tool_prints(encoded, src, flags):
    """The port's main(argv) output against the JAX tool's text (its
    dump_codestream writes to the sys.stdout of its import, so it is
    called with a buffer) and JSON."""
    data = (encoded / src).read_bytes()
    got = _run(pdump.main, ["-i", str(encoded / src)] + flags)
    if "-j" in flags:
        want = json.dumps(jdump.dump_json(data), indent=2) + "\n"
    else:
        buf = io.StringIO()
        jdump.dump_codestream(data, out=buf, verbose="-v" in flags)
        want = buf.getvalue()
    assert got == want
    assert "Main header:" in got or '"siz"' in got


def test_the_card_is_the_default():
    assert pcompress.build_parser().parse_args(
        ["-o", "x"]).device == "cuda"
    assert pdecompress.build_parser().parse_args(
        ["-o", "x"]).device == "cuda"

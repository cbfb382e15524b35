"""The port's tile-sharded encode and decode over processes
(grok_tpu_torch/parallel/distributed.py) on the CPU: the degenerate
one-process mode in-process, against the port's single-process entry
points, the JAX package's grok_tpu.parallel.distributed and
grok_tpu.compress / decompress at the parameters of
tests/test_distributed.py (its tiling and resolutions; the frames coded
in HT blocks, and Part-1 in 8x8 blocks, where the plain versions' cost on
the CPU stays small), the refusals (ht_mixed and ht_planes too, which the
JAX function ignores, and a tensor on another device than asked), and a
real two-process Gloo run of subprocess workers that import no JAX; and
the build's cross-process lock, two processes building one scratch build
directory cold."""

import os
import socket
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from grok_tpu import CompressParams as JCP  # noqa: E402
from grok_tpu import DecompressParams as JDP  # noqa: E402
from grok_tpu import compress, decompress, native  # noqa: E402
from grok_tpu.parallel import distributed as jdist  # noqa: E402
from grok_tpu.util.oracle import synthetic_image  # noqa: E402
from grok_tpu_torch import api  # noqa: E402
from grok_tpu_torch.core.params import CompressParams as PCP  # noqa: E402
from grok_tpu_torch.core.params import DecompressParams as PDP  # noqa: E402
from grok_tpu_torch.parallel.distributed import (  # noqa: E402
    compress_distributed, decompress_distributed, gather_bytes_to_host0,
    init_distributed)

pytestmark = pytest.mark.skipif(not native.available(),
                                reason="no C toolchain")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TILED = dict(tile_w=64, tile_h=64, num_resolutions=3, write_tlm=True)
CODERS = {"ht": dict(ht=True), "part1": dict(cblk_w_exp=3, cblk_h_exp=3)}


def _arr(comps):
    a = [c.numpy() for c in comps]
    return a[0] if len(a) == 1 else np.stack(a, -1)


def test_init_degenerate(monkeypatch):
    monkeypatch.delenv("GROK_COORDINATOR", raising=False)
    assert init_distributed() == (0, 1)


def test_gather_single_process_identity():
    assert gather_bytes_to_host0(b"\xff\x00abc") == [b"\xff\x00abc"]
    assert gather_bytes_to_host0(b"") == [b""]


@pytest.mark.parametrize("coder", list(CODERS))
def test_compress_distributed_matches_compress(coder):
    img = synthetic_image(200, 168, 1, seed=11)
    kw = dict(TILED, **CODERS[coder])
    got = compress_distributed(img, PCP(**kw), device="cpu")
    assert got == api.compress_device(img, PCP(**kw), device="cpu")
    assert got == compress(img, JCP(**kw)) == \
        jdist.compress_distributed(img, JCP(**kw))


@pytest.mark.parametrize("kw", [
    dict(jp2=True), dict(write_ppm=True), dict(write_plm=True),
    dict(roi_rect=(0, 0, 8, 8), roi_comp=0, roi_shift=4),
    dict(fixed_quality=True, quality=[40.0]), dict(max_tile_parts=2),
    dict(ht_mixed=True), dict(ht=True, ht_planes=1)])
def test_compress_distributed_refusals(kw):
    with pytest.raises(ValueError):
        compress_distributed(np.zeros((16, 16), np.uint8), PCP(**kw),
                             device="cpu")


def test_compress_distributed_refuses_auto_rd():
    from grok_tpu_torch.core.params import MCTMode
    with pytest.raises(ValueError, match="AUTO_RD"):
        compress_distributed(np.zeros((16, 16, 3), np.uint8),
                             PCP(mct=MCTMode.AUTO_RD), device="cpu")


@pytest.mark.parametrize("device", ["cuda", "cuda:0", "meta"])
def test_compress_distributed_tensor_on_another_device_raises(device):
    # as compress_device_batch: a tensor is never encoded where it lies
    # in place of the asked device, with or without a card
    frame = torch.zeros((16, 16), dtype=torch.int32)
    with pytest.raises(ValueError, match="asked to run on"):
        compress_distributed(frame, PCP(ht=True), device=device)


def test_compress_distributed_tensor_input_matches():
    img = synthetic_image(96, 80, 1, seed=4)
    kw = dict(TILED, ht=True)
    got = compress_distributed(torch.from_numpy(img.astype(np.int32)),
                               PCP(**kw), device="cpu")
    assert got == api.compress_device(img, PCP(**kw), device="cpu")


@pytest.fixture(scope="module")
def rgb_stream():
    img = synthetic_image(160, 128, 3, seed=2)
    return img, compress(img, JCP(num_resolutions=3, tile_w=64, tile_h=64,
                                  ht=True))


@pytest.mark.parametrize("reduce", [0, 1])
def test_decompress_distributed_single_process_matches(rgb_stream, reduce):
    img, cs = rgb_stream
    got = decompress_distributed(cs, PDP(reduce=reduce), device="cpu")
    want = api.decompress_device(cs, PDP(reduce=reduce), device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert np.array_equal(_arr(got), decompress(
        cs, JDP(reduce=reduce)).to_array())
    if not reduce:
        assert np.array_equal(_arr(got), img)


@pytest.mark.parametrize("win", [(10, 20, 100, 90), (64, 0, 160, 64)])
def test_decompress_distributed_window_matches(win):
    """The tiles outside the window stay 0, as decompress_device leaves
    them; inside the window, the JAX package's window decode."""
    img = synthetic_image(160, 128, 1, seed=5)
    cs = compress(img, JCP(num_resolutions=3, tile_w=64, tile_h=64,
                           ht=True))
    got = decompress_distributed(cs, PDP(window=win), device="cpu")
    want = api.decompress_device(cs, PDP(window=win), device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    x0, y0, x1, y1 = win
    assert np.array_equal(got[0].numpy()[y0:y1, x0:x1],
                          decompress(cs, JDP(window=win)).to_array())


def test_decompress_distributed_rejects_subset_modes():
    # the JAX function's refused subset decodes have no field in the
    # port's parameters: they are refused before any decode starts
    with pytest.raises(TypeError):
        PDP(tile_index=0)
    with pytest.raises(TypeError):
        PDP(components=[0])


_WORKER = textwrap.dedent("""
    import sys
    pid = int(sys.argv[1]); port = sys.argv[2]; outp = sys.argv[3]
    import numpy as np, torch
    torch.set_num_threads(1)
    from grok_tpu_torch.core.params import CompressParams
    from grok_tpu_torch.parallel.distributed import (
        compress_distributed, decompress_distributed, gather_bytes_to_host0,
        init_distributed, shutdown_distributed)
    from grok_tpu_torch.util.synth import synthetic_image
    got = init_distributed(f"127.0.0.1:{port}", 2, pid, timeout=120)
    assert got == (pid, 2), got
    blobs = gather_bytes_to_host0(bytes([pid]) * (10 + 90 * pid))
    assert blobs == [b"\\x00" * 10, b"\\x01" * 100], [len(b) for b in blobs]
    img = synthetic_image(200, 168, 1, seed=11)
    cp = CompressParams(tile_w=64, tile_h=64, num_resolutions=3,
                        write_tlm=True, ht=True)
    data = compress_distributed(img, cp, device="cpu")
    assert (data is None) == (pid != 0)
    data = gather_bytes_to_host0(data if pid == 0 else b"")[0]
    out = decompress_distributed(data, device="cpu")
    if pid == 0:
        open(outp, "wb").write(data)
        np.save(outp + ".npy", out[0].numpy())
    else:
        assert out is None
    shutdown_distributed()
    assert "jax" not in sys.modules and "grok_tpu" not in sys.modules
""")


def test_two_process_gloo(tmp_path):
    """Two processes over Gloo: the non-degenerate init, the
    variable-length gather, and the process-sharded encode and decode,
    equal to the single-process entry points."""
    outp = str(tmp_path / "dist.j2k")
    env = dict(os.environ, PYTHONPATH=REPO)
    env.pop("GROK_COORDINATOR", None)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    procs = [subprocess.Popen([sys.executable, "-c", _WORKER, str(i),
                               str(port), outp], env=env, cwd=REPO,
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT)
             for i in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=120)[0].decode(
                errors="replace"))
    finally:
        for p in procs:
            p.kill()
    assert all(p.returncode == 0 for p in procs), outs
    img = synthetic_image(200, 168, 1, seed=11)
    cp = dict(tile_w=64, tile_h=64, num_resolutions=3, write_tlm=True,
              ht=True)
    data = api.compress_device(img, PCP(**cp), device="cpu")
    assert open(outp, "rb").read() == data == compress(img, JCP(**cp))
    assert np.array_equal(np.load(outp + ".npy"), img)


_BUILD_WORKER = textwrap.dedent("""
    import sys
    from grok_tpu_torch import _build
    _build.BUILD_DIR = sys.argv[1]
    _build.load_host_library()
""")


def test_build_is_safe_across_processes(tmp_path):
    """Two processes starting cold on one scratch build directory build
    the host runtime once (the compiler is a wrapper that logs each
    run): the second waits on the directory's lock and loads the
    first's library."""
    import shutil
    log = tmp_path / "cc.log"
    cc = tmp_path / "cc"
    real = os.environ.get("CC") or shutil.which("cc") or "gcc"
    cc.write_text(f"#!/bin/sh\necho run >> {log}\nexec {real} \"$@\"\n")
    cc.chmod(0o755)
    build = tmp_path / "build"
    env = dict(os.environ, PYTHONPATH=REPO, CC=str(cc))
    procs = [subprocess.Popen([sys.executable, "-c", _BUILD_WORKER,
                               str(build)],
                              env=env, cwd=REPO, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT) for _ in range(2)]
    outs = [p.communicate(timeout=300)[0].decode(errors="replace")
            for p in procs]
    assert all(p.returncode == 0 for p in procs), outs
    assert log.read_text().split() == ["run"]
    libs = [f for f in os.listdir(build) if f.endswith(".so")]
    assert len(libs) == 1 and not [f for f in os.listdir(build)
                                   if f.endswith(".tmp")]

"""P1 of the port, the per-lane gather (grok_tpu_torch/ops/lane_gather.py):
its plain version against numpy's and JAX's take_along_axis (the body of
the Pallas probe in tools/hw_validate.py) on the probe's own inputs and
on other shapes, awkward ones (lane counts off the kernel's 4-lane
groups, row counts around its row tiles, indices out of range, unaligned
views) included, the wrappers' refusals (the kernel and its first
design), and every check of the port's hardware-validation tool
(grok_tpu_torch/tools/hw_validate.py) on the CPU at its small sizes."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from grok_tpu import native  # noqa: E402
from grok_tpu_torch.ops import lane_gather as G  # noqa: E402
from grok_tpu_torch.tools import hw_validate  # noqa: E402


def _probe_inputs(rows, L=128):
    """tools/hw_validate.py run_gather_probe's x and idx."""
    x = np.arange(rows * L, dtype=np.int32).reshape(rows, L)
    idx = np.random.default_rng(0).integers(0, rows, (rows, L),
                                            dtype=np.int32)
    return x, idx


def _random_inputs(rows, L, seed):
    rng = np.random.default_rng(seed)
    return (rng.integers(-2**31, 2**31, (rows, L), dtype=np.int32),
            rng.integers(0, rows, (rows, L), dtype=np.int32))


@pytest.mark.parametrize("make", [
    lambda: _probe_inputs(64),
    lambda: _probe_inputs(8),
    lambda: _random_inputs(1, 1, 1),
    lambda: _random_inputs(5, 3, 2),
    lambda: _random_inputs(300, 33, 3),
    lambda: _random_inputs(2, 1000, 4),
])
def test_plain_version_matches_numpy_and_jax(make):
    x, idx = make()
    got = G.lane_gather(torch.from_numpy(x), torch.from_numpy(idx))
    assert got.dtype == torch.int32 and got.shape == x.shape
    assert np.array_equal(got.numpy(), np.take_along_axis(x, idx, axis=0))
    want = jnp.take_along_axis(jnp.asarray(x), jnp.asarray(idx), axis=0)
    assert np.array_equal(got.numpy(), np.asarray(want))


AWKWARD = [(rows, L) for rows in (1, 63, 65) for L in (1, 3, 5, 127, 129)]


@pytest.mark.parametrize("rows, L", AWKWARD)
def test_plain_version_awkward_shapes(rows, L):
    """The plain version (and lane_gather_v1's, on the CPU) at lane counts
    off the kernel's 4-lane groups and row counts around its row tiles:
    numpy's take_along_axis, on in-range indices and, on the kernel's
    contract, 0 where an index is out of range; the tool's unaligned
    views give the same."""
    cases = hw_validate.gather_cases(rows, L, 7 * rows + L, "cpu")
    for what, x, idx in cases:
        got = G.lane_gather(x, idx)
        want = hw_validate.gather_want(x, idx)
        assert np.array_equal(got.numpy(), want), what
        assert torch.equal(G.lane_gather_v1(x, idx), got), what
    x, idx = cases[0][1].numpy(), cases[0][2].numpy()
    assert np.array_equal(G.lane_gather(torch.from_numpy(x),
                                        torch.from_numpy(idx)).numpy(),
                          np.take_along_axis(x, idx, axis=0))
    oor = cases[1][2].numpy()
    assert ((oor < 0) | (oor >= rows)).any()
    assert not G.lane_gather(cases[1][1], cases[1][2]).numpy()[
        (oor < 0) | (oor >= rows)].any()


def test_cpu_tensors_launch_no_kernel():
    x, idx = _probe_inputs(16)
    before = G.lane_gather.launches, G.lane_gather_v1.launches
    G.lane_gather(torch.from_numpy(x), torch.from_numpy(idx))
    G.lane_gather_v1(torch.from_numpy(x), torch.from_numpy(idx))
    assert (G.lane_gather.launches, G.lane_gather_v1.launches) == before


def test_wrapper_refusals():
    x = torch.zeros((4, 8), dtype=torch.int32)
    idx = torch.zeros((4, 8), dtype=torch.int32)
    bad = [
        (x.long(), idx, "dtype"),
        (x, idx.long(), "dtype"),
        (x, idx[:3], "shape"),
        (x[0], idx[0], r"\(rows, L\)"),
        (x[:0], idx[:0], r"\(rows, L\)"),
        (x.t(), idx.t(), "contiguous"),
        (x.to("meta"), idx, "is on"),
        (x.to("meta"), idx.to("meta"), "no lane gather kernel"),
    ]
    for a, b, what in bad:
        for fn in (G.lane_gather, G.lane_gather_v1):
            with pytest.raises(ValueError, match=what):
                fn(a, b)


def test_tool_refuses_unknown_checks_and_a_missing_card(capsys):
    with pytest.raises(SystemExit):
        hw_validate.main(["--device", "cpu", "no_such_check"])
    if not torch.cuda.is_available():
        assert hw_validate.main(["gather_probe"]) == 2
        assert "CUDA is not available" in capsys.readouterr().err


@pytest.mark.skipif(not native.available(), reason="no C toolchain")
@pytest.mark.parametrize("check", hw_validate.CHECKS)
def test_tool_check_on_cpu(check, capsys):
    """Each check of the tool at its small CPU sizes: every result ok,
    one printed line per result."""
    results = hw_validate.run(check, "cpu")
    assert results and all(r["ok"] for r in results), results
    assert all(r["device"] == "cpu" for r in results)
    out = capsys.readouterr().out
    assert out.count(f"{check} ") >= len(results)
    if check == "gather_probe":
        assert [r["rows"] for r in results] == [64, 512]
        assert all(r["bound_ms"] is None for r in results)

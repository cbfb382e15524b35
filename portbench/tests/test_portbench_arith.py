"""The window arithmetic, the device trace's idle share and the
roofline byte counts."""

import json
import statistics

import pytest
import torch

from portbench import roofline, synth
from portbench.devtrace import DeviceTrace, short_name
from portbench.window import Window, percentile


def test_rate_is_all_work_over_all_time():
    w = Window()
    # three calls, the second one slow; a gap of host time between calls
    w.add(10.0, 10.1, 8)
    w.add(10.2, 11.2, 8)
    w.add(11.3, 11.4, 8)
    assert w.calls == 3
    assert w.seconds == pytest.approx(1.4)
    assert w.rate() == pytest.approx(24 / 1.4)
    # not the mean of per-call rates, nor work over the sum of call times
    assert w.rate() != pytest.approx(statistics.mean([80, 8, 80]))
    assert w.rate() != pytest.approx(24 / 1.2)
    assert Window().rate() is None


def test_p95_is_over_every_call():
    vals = [float(i) for i in range(1, 101)]
    assert percentile(vals, 95) == 95.0
    assert percentile(vals[::-1], 95) == 95.0
    # a tail in one chunk: medians of chunks would hide it
    calls = [1.0] * 90 + [50.0] * 10
    chunks = [statistics.median(calls[i:i + 10]) for i in range(0, 100, 10)]
    assert percentile(calls, 95) == 50.0
    assert percentile(chunks, 95) == 50.0 or max(chunks) == 50.0
    assert percentile([3.0], 95) == 3.0
    assert percentile([], 95) is None


def _ev(cat, name, ts, dur, dev=0):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "pid": dev, "args": {"device": dev}}


def _timeline():
    """Two calls (0-100 us, 100-200 us); card 0 busy 10-30, 20-40
    (overlapping), 150-160; a copy 60-70; card 1 busy 0-200."""
    return [
        _ev("user_annotation", "pb:call", 0, 100),
        _ev("user_annotation", "pb:call", 100, 100),
        _ev("user_annotation", "pb:decode_stage", 40, 55),
        _ev("user_annotation", "pb:decode_program", 120, 80),
        _ev("kernel", "void ht_decode_kernel<false>(int*)", 10, 20),
        _ev("kernel", "void ht_decode_wide_kernel(int*)", 20, 20),
        _ev("gpu_memcpy", "Memcpy HtoD (Pinned -> Device)", 60, 10),
        _ev("kernel", "void t1_decode_kernel(int*)", 150, 10),
        _ev("kernel", "void t1_decode_kernel(int*)", 0, 200, dev=1),
        _ev("cpu_op", "aten::add", 0, 5),
    ]


def test_idle_share_from_a_synthetic_timeline(tmp_path):
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": _timeline()}))
    t = DeviceTrace.from_file(str(path), [0, 1])
    assert t.calls == 2
    assert t.window_s == pytest.approx(200e-6)
    assert t.busy_s(0) == pytest.approx(50e-6)       # 10-40, 60-70, 150-160
    assert t.idle_pct(0) == pytest.approx(75.0)
    assert t.idle_pct(1) == pytest.approx(0.0)
    assert t.mean_busy_s() == pytest.approx(125e-6)
    # whole-word kernel names: the wide kernel is not K1
    assert t.kernel_s("ht_decode_kernel") == pytest.approx(20e-6)
    assert t.kernel_s("t1_decode_kernel") == pytest.approx(210e-6)
    gaps = dict(t.idle_gaps())
    # card 0 idle 0-10 (call), 40-60 (staging), 70-95 (staging), 95-120
    # (call), 120-150 and 160-200 (program)
    assert gaps["decode_stage"] == pytest.approx(45e-6)
    assert gaps["call"] == pytest.approx(35e-6)
    assert gaps["decode_program"] == pytest.approx(70e-6)
    assert sum(gaps.values()) == pytest.approx(150e-6)
    ops = dict(t.device_ops())
    assert ops["t1_decode_kernel"] == pytest.approx(210e-6)
    assert short_name("void k<a(b)>(int*, float)") == "k<a(b)>"


def test_no_device_events_read_no_idle_share():
    t = DeviceTrace([_ev("user_annotation", "pb:call", 0, 100)], [0])
    assert t.mean_busy_s() == 0.0
    from portbench import spec
    from portbench.harness import Readings
    r = Readings("w", {}, {"direction": "decode"}, "NVIDIA H100 80GB HBM3",
                 1.0, Window(), {}, t, {"stream_bytes": 1, "samples": 1})
    assert spec.reader("device_idle_pct.decode")(r) is None
    assert spec.reader("k1_roofline")(r) is None


def test_roofline_bytes_from_a_tiny_stream():
    from grok_tpu_torch import api
    from portbench import spec
    from portbench.harness import compress_params
    src = synth.pool(1, 24, 40, 3, 7, "cpu")
    p = compress_params(spec.config("htj2k-1080p-rgb-lossless"),
                        num_resolutions=3)
    stream = api.compress_device_batch(
        [[src[0, c].to(torch.int32) for c in range(3)]], p, prec=8,
        device="cpu")[0]
    samples = 24 * 40 * 3
    assert roofline.decoder_bytes(len(stream), samples) == \
        len(stream) + 4 * samples
    nb = roofline.decoder_bytes(len(stream), samples)
    t_least = nb / 3.35e12
    assert roofline.share_pct(nb, 4 * t_least, "NVIDIA H100 80GB HBM3") \
        == pytest.approx(25.0)
    assert roofline.share_pct(nb, 0.0, None) is None


def test_pool_is_seeded_and_the_same_shape_for_every_seed():
    a = synth.pool(3, 16, 24, 3, 2**31 + 11, "cpu")
    b = synth.pool(3, 16, 24, 3, 2**31 + 11, "cpu")
    c = synth.pool(3, 16, 24, 3, 2**33 + 1, "cpu")
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert a.shape == c.shape == (3, 3, 16, 24) and a.dtype == torch.uint8
    assert not torch.equal(a[0], a[1])

"""The program's spans in the traced stretch (`portbench/spans.py`): device
time, launches and idle time inside each span from synthetic chrome-trace
events, idle gaps named by the innermost span, the span metrics' readers
and their entries in `BENCHMARK.json`."""

import json
import time

import pytest
import torch

from portbench import harness, spans, trace
from portbench.tests.test_portbench_trace import ev

NEW = {"encoder_ms.video": ("encoder", "video_fps"), "decoder_ms.video": ("decoder", "video_fps"),
       "launches.video": ("whole frame", "video_fps"),
       "launches.train": ("whole step", "train_samples_per_s"),
       "history_ms.train": ("whole step", "train_samples_per_s"),
       "backward_ms.train": ("whole step", "train_samples_per_s"),
       "optimizer_ms.train": ("loss, optimizer", "train_samples_per_s"),
       "match_idle_ms.train": ("loss, optimizer", "train_samples_per_s")}


def launch(ts, corr, tid=1):
    return ev("cuda_runtime", "cudaLaunchKernel", ts, 1, tid=tid, correlation=corr)


def test_prefix_is_the_programs():
    from bevformer_torch.utils.profiler import SPAN_PREFIX

    assert spans.PREFIX == SPAN_PREFIX


def test_span_counts_what_any_thread_launched_inside_it():
    events = [
        ev("user_annotation", "bevformer::backward", 0, 100),
        launch(10, 1),
        launch(50, 2, tid=2),  # the autograd engine's thread
        launch(150, 3),  # after the span
        ev("kernel", "k1", 20, 30, correlation=1),
        ev("gpu_memcpy", "copy", 60, 10, correlation=2),
        ev("kernel", "k3", 160, 40, correlation=3),
    ]
    s = spans.collect(events)["backward"]
    assert s["calls"] == 1 and s["host_ms"] == 0.1
    assert abs(s["device_ms"] - 0.04) < 1e-12  # k1 and the copy
    assert s["launches"] == 1  # kernels only


def test_span_idle_is_the_idle_time_inside_it():
    events = [
        ev("user_annotation", "bevformer::match", 100, 200),
        ev("kernel", "before", 50, 80),  # busy 100-130 of the span
        ev("kernel", "a", 150, 20),
        ev("gpu_memset", "b", 160, 20),  # overlaps a: busy 150-180
        ev("kernel", "after", 280, 100),  # busy 280-300
    ]
    s = spans.collect(events)["match"]
    assert abs(s["idle_ms"] - (200 - 30 - 30 - 20) / 1e3) < 1e-12
    assert s["device_ms"] == 0.0  # nothing launched inside it


def test_gaps_named_by_the_innermost_span(monkeypatch):
    step = ev("user_annotation", "bevformer::step", 0, 10_000)
    match = ev("user_annotation", "bevformer::match", 1000, 1000)
    ops = [ev("cpu_op", "aten::add", 100 + i, 1) for i in range(600)]  # past the look-back
    device = [ev("kernel", "k", 0, 1000), ev("kernel", "k", 1200, 100),
              ev("kernel", "k", 3000, 7000), ev("kernel", "k", 10_500, 100)]
    events = [step, match] + ops + device
    gaps = dict(spans.idle_gaps(device, ops, [step, match]))
    assert gaps == {"bevformer::step": 1700 / 1e6, "bevformer::match": 200 / 1e6,
                    "(no host op)": 500 / 1e6}
    # without the program's spans the gaps read as before
    assert spans.idle_gaps(device, ops, []) == trace.idle_gaps(device, ops)
    # and the old look-back misses the root span: its gap read as no host op
    assert abs(dict(trace.idle_gaps(device, ops + [step, match]))["(no host op)"]
               - (1700 + 500) / 1e6) < 1e-12
    # installed, summarise names them so and keeps every other field
    base = getattr(trace.summarise, "__wrapped__", trace.summarise)
    monkeypatch.setattr(trace, "summarise", base)  # as before a span reader is loaded
    before = trace.summarise(events)
    spans.install()
    spans.install()  # once in a process
    assert trace.summarise.__wrapped__ is base
    after = trace.summarise(events)
    assert after["idle_gaps"] == spans.idle_gaps(device, ops, [step, match])
    assert "spans" not in before and after["spans"]["step"]["calls"] == 1
    assert {k: v for k, v in after.items() if k not in ("spans", "idle_gaps")} == \
        {k: v for k, v in before.items() if k != "idle_gaps"}


@pytest.mark.parametrize("name", sorted(NEW))
def test_span_metric_entry_and_reader(name):
    bench = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
    entry = [m for m in bench["per_layer"] if m["name"] == name]
    assert len(entry) == 1
    m = entry[0]
    assert set(m) == {"name", "unit", "better", "source", "layer", "moves", "workloads"}
    assert (m["layer"], m["moves"]) == NEW[name]
    assert m["source"] == "device_trace" and m["better"] == "lower"
    assert m["unit"] == ("launches" if name.startswith("launches.") else "ms")
    # appended after the accepted entries, in this order
    assert [x["name"] for x in bench["per_layer"][-len(NEW):]] == list(NEW)
    rd = harness.reader(name)
    unit = "step" if name.endswith(".train") else "frame"
    ctx = harness.Context(None, None, unit, 0.0, 1.0, 1, [], 0, True,
                          dict(units=2, busy_s=1.0, ranges={}))
    assert rd.read(ctx) is None  # a program without spans: nothing to read
    full = dict(calls=2, host_ms=8.0, device_ms=6.0, launches=10, idle_ms=4.0)
    ctx.trace["spans"] = {k: dict(full) for k in
                          ("frame", "step", "encoder", "decoder", "history", "backward", "clip",
                           "optimizer", "match")}
    want = {"optimizer_ms": 6.0, "match_idle_ms": 2.0, "launches": 5.0}
    assert rd.read(ctx) == want.get(name.partition(".")[0], 3.0)


@pytest.mark.parametrize("name", ["base.video", "base.train"])
def test_traced_run_reads_the_spans(tiny, name):
    """A traced run at a tiny size on the CPU: every span metric of the cell
    is in the result (no device work there: launches and device ms 0)."""
    out = harness.run(tiny(name), 2 ** 31 + 13, 0.01, True, torch.device("cpu"),
                      time.perf_counter(), log=lambda m: None)
    want = sorted(n for n in NEW if n.endswith(".train" if name == "base.train" else ".video"))
    assert sorted(set(out["metrics"]) & set(NEW)) == want
    assert out["correct"], out["checks"]

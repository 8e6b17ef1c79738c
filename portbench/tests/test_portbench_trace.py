"""The traced stretch's reduction: device time by range, forward and
backward through the sequence numbers, busy time and idle gaps."""

from portbench import trace


def ev(cat, name, ts, dur, tid=1, **args):
    return dict(ph="X", cat=cat, name=name, ts=ts, dur=dur, tid=tid, args=args)


def test_ranges_forward_and_backward():
    events = [
        ev("user_annotation", "pb::dcn", 0, 50),
        ev("cpu_op", "aten::conv", 5, 10, **{"Sequence number": 7}),
        ev("cuda_runtime", "cudaLaunchKernel", 6, 1, correlation=1),
        ev("cuda_runtime", "cudaLaunchKernel", 20, 1, correlation=2),
        ev("cuda_runtime", "cudaLaunchKernel", 60, 1, correlation=3),  # outside the range
        ev("cpu_op", "autograd::engine::evaluate_function: ConvBackward0", 100, 30, tid=2,
           **{"Sequence number": 7}),
        ev("cuda_runtime", "cudaLaunchKernel", 110, 1, tid=2, correlation=4),
        ev("cpu_op", "autograd::engine::evaluate_function: AddBackward0", 140, 30, tid=2,
           **{"Sequence number": 8}),
        ev("cuda_runtime", "cudaLaunchKernel", 150, 1, tid=2, correlation=5),
        ev("kernel", "k1", 10, 100, correlation=1),
        ev("kernel", "k2", 110, 200, correlation=2),
        ev("kernel", "k3", 400, 1000, correlation=3),
        ev("kernel", "k4", 1500, 2000, correlation=4),
        ev("kernel", "k5", 4000, 500, correlation=5),
    ]
    s = trace.summarise(events)
    r = s["ranges"]["dcn"]
    assert r["calls"] == 1 and abs(r["fwd_ms"] - 0.3) < 1e-12 and abs(r["bwd_ms"] - 2.0) < 1e-12
    assert abs(s["busy_s"] - 3.8e-3) < 1e-12
    assert s["device_ops"][0] == ["k4", 2e-3]
    gaps = dict(s["idle_gaps"])
    assert abs(sum(gaps.values()) - (90 + 100 + 500) / 1e6) < 1e-12
    assert abs(trace.layer_device_ms(s, "dcn") - 2.3) < 1e-12
    assert trace.layer_device_ms(s, "msda") is None


def test_ranges_hooks_on_module_instances():
    import torch

    m = torch.nn.Sequential(torch.nn.Linear(4, 4), torch.nn.ReLU(), torch.nn.Linear(4, 2))
    assert len(trace.select(m, ["class:Linear"])) == 2
    assert trace.select(m, ["path:1"]) == [m[1]]
    hooks = trace.Ranges(m, {"lin": ["class:Linear"]})
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        m(torch.randn(3, 4))
    hooks.close()
    names = [e.name for e in prof.events()]
    assert names.count("pb::lin") == 2 and not hooks.open

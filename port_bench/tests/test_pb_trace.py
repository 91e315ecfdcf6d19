"""The reading of a profiler trace: the device's busy time is the union of
its intervals, and each kernel belongs to the ranges that launched it."""

import torch

from port_bench import trace


def test_union_and_spans():
    label = "pb:m:f"
    events = [
        {"ph": "X", "cat": "user_annotation", "name": label, "ts": 0,
         "dur": 10, "tid": 1},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
         "ts": 2, "dur": 1, "tid": 1, "args": {"correlation": 1}},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
         "ts": 12, "dur": 1, "tid": 1, "args": {"correlation": 2}},
        {"ph": "X", "cat": "kernel", "name": "a", "ts": 5, "dur": 10,
         "args": {"correlation": 1}},
        {"ph": "X", "cat": "kernel", "name": "b", "ts": 8, "dur": 10,
         "args": {"correlation": 2}},
        {"ph": "X", "cat": "gpu_memcpy", "name": "c", "ts": 30, "dur": 5},
        {"ph": "X", "cat": "cpu_op", "name": "aten::item", "ts": 18,
         "dur": 12, "tid": 1},
    ]
    tr = trace.TraceReadings(nr=1, naz=1, dtype=torch.float64)
    trace.read_device(events, tr)
    trace.read_ranges(events, {label}, tr)
    assert tr.busy_s == (13 + 5) / 1e6         # [5, 18] and [30, 35]
    assert tr.spans[label] == [10 / 1e6]       # kernel a only
    assert [k for k, _ in tr.kernels] == ["a", "b"]
    assert tr.breakdown["idle_gaps"] == [["aten::item", 12 / 1e6]]


def test_wrapped_restores_the_original():
    from fargocpt_torch.ops import kernels
    before = kernels.transport
    with trace.wrapped([("fargocpt_torch.ops.kernels", "", "transport")]):
        assert kernels.transport is not before
    assert kernels.transport is before

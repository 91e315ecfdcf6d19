"""roofline_pct.kernels: the least time of every op that the port runs as
a hand-written CUDA kernel on the cell's path (``roofline.TRAFFIC``),
summed over their calls, over the device time of everything launched
inside those calls, in %. Keyed by op, not by kernel symbol, so a kernel
fused, split or rewritten is read against the same work."""

from port_bench import roofline
from port_bench.trace import span_label

SPANS = tuple(("fargocpt_torch.ops.kernels", "", op)
              for op in roofline.TRAFFIC)


def read(tr):
    least = device_s = 0.0
    for spec in SPANS:
        calls = tr.spans.get(span_label(spec), [])
        least += len(calls) * roofline.least_s(
            spec[2], tr.nr, tr.naz, tr.dtype.itemsize)
        device_s += sum(calls)
    if device_s <= 0.0:
        return None
    return 100.0 * least / device_s

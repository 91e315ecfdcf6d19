"""roofline_pct.transport: the FARGO transport's least time (the frozen
bytes of ``port_bench/roofline.py`` at the HBM rate, or its operations at
the dtype's rate, whichever is longer) over the device time of
everything launched inside the ``ops.kernels.transport`` calls, in %."""

from port_bench import roofline
from port_bench.trace import span_label

SPANS = (("fargocpt_torch.ops.kernels", "", "transport"),)


def read(tr):
    calls = tr.spans.get(span_label(SPANS[0]), [])
    device_s = sum(calls)
    if not calls or device_s <= 0.0:
        return None
    least = len(calls) * roofline.least_s(
        "transport", tr.nr, tr.naz, tr.dtype.itemsize)
    return 100.0 * least / device_s

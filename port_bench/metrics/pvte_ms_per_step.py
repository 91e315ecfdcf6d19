"""pvte_ms_per_step: device time launched inside ``ops.pvte.PVTE.gamma_mu``
(the PVTE refresh), per hydro step of the traced window."""

from port_bench.trace import span_label

SPANS = (("fargocpt_torch.ops.pvte", "PVTE", "gamma_mu"),)


def read(tr):
    calls = tr.spans.get(span_label(SPANS[0]), [])
    total = sum(calls)
    if not calls or total <= 0.0 or tr.traced_steps <= 0:
        return None
    return 1e3 * total / tr.traced_steps

"""artvisc_ms_per_step: device time launched inside
``ops.artvisc.update_with_artificial_viscosity`` (the TW or SN artificial
viscosity of the unfused substeps, with its dissipation), per hydro step
of the traced window. None where the window made no such call: a run on
the fused viscous kick, or with the SN kernel, never calls it."""

from port_bench.trace import span_label

SPANS = (("fargocpt_torch.ops.artvisc", "",
          "update_with_artificial_viscosity"),)


def read(tr):
    calls = tr.spans.get(span_label(SPANS[0]), [])
    total = sum(calls)
    if not calls or total <= 0.0 or tr.traced_steps <= 0:
        return None
    return 1e3 * total / tr.traced_steps

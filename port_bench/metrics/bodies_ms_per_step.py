"""bodies_ms_per_step: device time launched inside the bodies' calls, per
hydro step of the traced window: the N-body integration
(``nbody.system.integrate``: IAS15, the drift and the indirect term's
predictor), the rest of the predictor
(``ops.gravity.indirect_term_nbody_predictor``), the disk's pull on the
bodies (``ops.gravity.disk_on_body_accel``) and its indirect term
(``ops.gravity.indirect_term_disk``), the bodies on the grid
(``step.HydroStep.bodies_on_grid``: the ramped masses and the cubic
smoothing radii) and the bodies' potential on the grid
(``ops.gravity.nbody_potential``; on the card the sources kernel computes
the step's potential in its own launch, which this leaves out).

A kernel is counted in every range that holds its launch, and each
predictor call holds one ``integrate`` call: the predictor of a step comes
before its drift, so the calls of ``integrate`` alternate, the predictor's
first. Their device time is counted once, under ``integrate``. None where
the calls do not pair so (not two ``integrate`` calls a predictor call),
or the window made none."""

from port_bench.trace import span_label

INTEGRATE = ("fargocpt_torch.nbody.system", "", "integrate")
PREDICTOR = ("fargocpt_torch.ops.gravity", "",
             "indirect_term_nbody_predictor")
SPANS = (INTEGRATE, PREDICTOR,
         ("fargocpt_torch.ops.gravity", "", "disk_on_body_accel"),
         ("fargocpt_torch.ops.gravity", "", "indirect_term_disk"),
         ("fargocpt_torch.ops.gravity", "", "nbody_potential"),
         ("fargocpt_torch.step", "HydroStep", "bodies_on_grid"))


def read(tr):
    calls = {spec: tr.spans.get(span_label(spec), []) for spec in SPANS}
    integ, pred = calls[INTEGRATE], calls[PREDICTOR]
    if not integ or tr.traced_steps <= 0 or len(integ) != 2 * len(pred):
        return None
    nested = integ[0::2]
    if any(p < i for p, i in zip(pred, nested)):
        return None
    total = sum(sum(c) for c in calls.values()) - sum(nested)
    if total <= 0.0:
        return None
    return 1e3 * total / tr.traced_steps

"""launches_per_step: device kernels in the traced window per hydro step
(the step glue's PyTorch ops and the hand-written kernels alike)."""

SPANS = ()


def read(tr):
    if not tr.kernels or tr.traced_steps <= 0:
        return None
    return len(tr.kernels) / tr.traced_steps

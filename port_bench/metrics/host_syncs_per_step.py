"""host_syncs_per_step: the host's waits for the card per hydro step, as
CUDA's sync debug mode warns of them over the calls that follow the
profiled ones (the landing test of ``advance_to``, FLD's block reads, the
monitor's statistics)."""

SPANS = ()


def read(tr):
    if not tr.kernels or tr.sync_steps <= 0:
        return None
    return tr.syncs / tr.sync_steps

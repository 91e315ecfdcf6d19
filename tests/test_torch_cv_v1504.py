"""The cataclysmic variables (ROADMAP A.9, second half), continued:
fargocpt_torch's Simulation against the JAX package's, both on the CPU in
float64, rtol 1e-10 (``tests/test_torch_cv.py``'s ``assert_cv_states``),
on ``setups/V1504Cyg.yml`` read as it stands at 16x32 for five steps: the
leapfrog, PVTE, AspectRatioMode 1, AlphaMode 1, StabilizeViscosity 1, TW
artificial viscosity, S-curve cooling on the PVTE mean molecular weight
and the Roche-lobe stream (the leapfrog keeps no tracker, as in the JAX
package: its rate stays 0).

The setup's CFL dt is ~1e-15 here: its heating/cooling term in the last
active ring, which the stream's ghost ring shears (ROADMAP C). A step of
that dt moves no field, so both packages step on a fixed dt of 1e-4,
under the FARGO shear limit of ~4e-3; their CFL dts are still held to
each other, and each field and the S-curve's Q- are seen to move far above
the tolerance. Once at the setup's own ramp (the stream at the density
floor) and once with ``ROFrampingtime`` 1e-7 (the stream carries mass).
"""

import pytest
import torch

from fargocpt_torch.config import Config
from fargocpt_torch.flagship import V1504CYG, setup_file
from fargocpt_torch.sim import Simulation

from test_torch_cv import RTOL, run_cv_pair

torch.set_num_threads(2)

V1504_DT = 1e-4


def _assert_moved(new, old, label):
    moved = float(torch.linalg.norm(new - old) / torch.linalg.norm(old))
    assert moved > 1e4 * RTOL, f"{label} moved by {moved:.3e} only"


@pytest.mark.parametrize("ramp", ["own", "short"])
def test_v1504cyg_matches_jax(ramp):
    over = {"ROFrampingtime": "1e-7"} if ramp == "short" else {}
    cfg = setup_file(V1504CYG, 16, 32, **over)
    start = Simulation(Config.from_dict(dict(cfg)), device="cpu").state
    ts, _ = run_cv_pair(cfg, 5, dt=V1504_DT)
    for name in ("sigma", "vrad", "vaz", "energy"):
        _assert_moved(getattr(ts.fields, name), getattr(start.fields, name),
                      name)
    _assert_moved(ts.state.qminus, start.qminus, "qminus")
    floor = ts.phys.sigma_floor * ts.phys.sigma0
    stream = float(ts.fields.sigma[-1].max())
    assert stream > 1e3 * floor if ramp == "short" else stream == floor
    st = ts.stepper
    assert ts.phys.variable_gamma and ts.phys.cooling_scurve_enabled
    assert ts.phys.hydro_integrator == "leapfrog"
    assert not any(st.gates[k] for k in ("sources", "viscous_kick", "cfl",
                                         "artvisc_sn"))
    assert float(ts.state.monitor_acc.rof_mdot) == 0.0

"""The cataclysmic variables (ROADMAP A.9, second half), continued:
``KeepDiskMassConstant`` on the Euler and the leapfrog step,
fargocpt_torch's Simulation against the JAX package's, both on the CPU in
float64, rtol 1e-10 (``tests/test_torch_cv.py``'s ``assert_cv_states``),
on ``setups/CloseBinaries/OY_Car.yml`` at 16x32 with the stream's ramp
ending in the first step, so mass flows in and the rescaling takes it out:
the disk's mass inside Rmax stays the initial one to 1e-13.
"""

import pytest
import torch

from fargocpt_torch.flagship import OY_CAR, setup_file
from fargocpt_torch.ops import quantities as quant

from test_torch_cv import run_cv_pair

torch.set_num_threads(2)


@pytest.mark.parametrize("integrator", ["Euler", "LeapFrog"])
def test_keep_disk_mass_constant_matches_jax(integrator):
    cfg = setup_file(OY_CAR, 16, 32, KeepDiskMassConstant="yes",
                     Integrator=integrator, ROFrampingtime="1e-7",
                     FirstDT="1e-7")
    ts, _ = run_cv_pair(cfg, 5)
    st = ts.stepper
    m0 = float(quant.total_mass(ts.phys, st.g, st.ref_sigma0, st.rmax))
    m = float(quant.total_mass(ts.phys, st.g, ts.fields.sigma, st.rmax))
    assert abs(m / m0 - 1.0) < 1e-13
    assert not torch.equal(ts.fields.sigma, st.ref_sigma0)

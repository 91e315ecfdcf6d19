"""The rest of the initial conditions on fargocpt_torch against the JAX
package, float64 on the CPU: the simplex noise of ``RandomSigma`` and the
randomised Sigma, the ``CentrifugalBalance`` v_az (ideal gas and locally
isothermal), the disk around the secondary (``SecondaryDisk``), and the
PVTE shock tube's fields.

Both packages build these in numpy on the host with the same expressions,
so the fields agree to rtol 1e-14 (the noise bit for bit); the secondary
disk's v_rad is the viscous drift, a finite difference of pow()-based
profiles that the JAX package evaluates with XLA's pow: rtol 1e-9
(tests/test_torch_slice.py says why), and atol 1e-12 of its largest
value, since about the secondary it is the small difference of terms of
the orbital speed. Each configuration then takes ten
steps through ``Simulation`` against the JAX package on one dt sequence
(rtol 1e-10, v_rad to 1e-9 of its largest value)."""

import numpy as np
import pytest
import torch

from fargocpt_tpu import initial as j_initial

from fargocpt_torch import initial

from longtail_pairs import (BASE, assert_fields, build_pair, moved, snapshot,
                            step_pair)

torch.set_num_threads(2)

# a companion of 0.3 at r = 1.2: its Roche lobe (0.34) reaches past the
# closest a cell may be to it (Rmin / 3)
TWO_BODIES = [{"name": "star", "semi-major axis": "0.0", "mass": "1.0"},
              {"name": "companion", "semi-major axis": "1.2", "mass": "0.3"}]
CASES = {
    "random": dict(BASE, RandomSigma="Yes", RandomFactor="0.1",
                   FeatureSize="0.05", RandomSeed="7"),
    "balance_ideal": dict(BASE, CentrifugalBalance="Yes"),
    "balance_isothermal": dict(BASE, CentrifugalBalance="Yes",
                               EquationOfState="Isothermal"),
    # Sigma ~ 1/r, steep enough that the secondary's disk exceeds the
    # gas already there near the secondary
    "secondary_ideal": dict(BASE, SecondaryDisk="Yes", SigmaSlope="1.0",
                            ProfileCutoffPointOuter="0.8",
                            ProfileCutoffWidthOuter="0.1",
                            nbody=TWO_BODIES),
    "secondary_keplerian": dict(BASE, SecondaryDisk="Yes", SigmaSlope="1.0",
                                EquationOfState="Isothermal",
                                InitializePureKeplerian="Yes",
                                ProfileCutoffPointOuter="0.8",
                                ProfileCutoffWidthOuter="0.1",
                                nbody=TWO_BODIES),
}


def test_simplex_noise_matches_jax():
    rng = np.random.default_rng(11)
    x, y = rng.uniform(-40.0, 40.0, (2, 64, 32))
    for seed in (0, 7, 1337):
        np.testing.assert_array_equal(initial.simplex_noise_2d(x, y, seed),
                                      j_initial.simplex_noise_2d(x, y, seed))
    n = initial.simplex_noise_2d(x, y, 0)
    assert np.abs(n).max() <= 1.0 and np.abs(n).max() > 0.1


@pytest.mark.parametrize("case", sorted(CASES))
def test_initial_state_matches_jax(case):
    js, ts = build_pair(CASES[case])
    for name in ("sigma", "vrad", "vaz", "energy"):
        ref = np.asarray(getattr(js.state.fields, name))
        rtol = 1e-9 if name == "vrad" else 1e-14
        atol = 1e-12 * np.abs(ref).max() if name == "vrad" else 0.0
        np.testing.assert_allclose(getattr(ts.state.fields, name).numpy(),
                                   ref, rtol=rtol, atol=atol, err_msg=name)
    before = snapshot(ts)
    step_pair(js, ts, 10)
    assert_fields(ts.state, js.state)
    assert moved(ts, before)["sigma"] > 1e-6


def test_the_long_tail_changes_the_fields():
    """Each option changes what it should against the plain disk."""
    _, plain = build_pair(BASE)
    p = plain.state.fields
    _, ts = build_pair(CASES["random"])
    ratio = (ts.state.fields.sigma / p.sigma).numpy()
    assert 0.85 < ratio.min() < 0.99 and 1.01 < ratio.max() < 1.15
    _, ts = build_pair(CASES["balance_ideal"])
    assert not torch.equal(ts.state.fields.vaz, p.vaz)
    assert torch.equal(ts.state.fields.sigma, p.sigma)
    _, plain = build_pair(dict(BASE, SigmaSlope="1.0"))
    p = plain.state.fields
    _, ts = build_pair(CASES["secondary_ideal"])
    f = ts.state.fields
    assert (f.sigma >= p.sigma).all() and (f.sigma > 1.5 * p.sigma).any()
    assert not torch.equal(f.vaz, p.vaz)

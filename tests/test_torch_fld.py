"""fargocpt_torch's FLD radiative diffusion against fargocpt_tpu's on the
same seeded fields, in float64 on the CPU: the diffusion coefficients,
the matrix, the red-black SOR solve (the same iteration count, T to
rtol 1e-12) and the auto-omega walk.

The port tests convergence once per block of sweeps with the sweeps past
convergence masked out, so its result does not depend on the block
length; one test holds block lengths 1 and 7 to bitwise equality.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from fargocpt_tpu.constants import Constants as JConstants
from fargocpt_tpu.grid import Geometry as JGeometry
from fargocpt_tpu.ops import fld as j_fld
from fargocpt_tpu.ops.common import prepare_geom as j_prepare_geom
from fargocpt_tpu.params import Physics as JPhysics
from fargocpt_tpu.units import Units as JUnits

from fargocpt_torch.constants import Constants
from fargocpt_torch.grid import Geometry
from fargocpt_torch.ops import fld
from fargocpt_torch.ops.common import Geom
from fargocpt_torch.params import Physics
from fargocpt_torch.units import Units

torch.set_num_threads(2)

NR, NAZ = 24, 48
RTOL = 1e-12
ARGS = ("1 au", "1 solMass", None, None)


def _solvers(**cfg):
    phys = dict(eos="adiabatic", adiabatic_index=1.4,
                minimum_temperature=1e-4, radiative_diffusion=True)
    ju, tu = JUnits.from_config_strings(*ARGS), \
        Units.from_config_strings(*ARGS)
    jgeom = JGeometry.build(NR, NAZ, 0.4, 2.5, "Log")
    tgeom = Geometry.build(NR, NAZ, 0.4, 2.5, "Log")
    config = dict(tolerance=1e-14, max_iterations=200, omega=1.5)
    config.update(cfg)
    js = j_fld.FLDSolver(JPhysics(**phys), JConstants.from_units(ju), ju,
                         jgeom, j_fld.FLDConfig(**config), jnp.float64)
    ts = fld.FLDSolver(Physics(**phys), Constants.from_units(tu), tu, tgeom,
                       fld.FLDConfig(**config), torch.float64)
    return js, ts, j_prepare_geom(jgeom, jnp.float64), \
        Geom(tgeom, torch.float64)


@pytest.fixture(scope="module")
def fields():
    rng = np.random.default_rng(17)
    sigma = (rng.random((NR, NAZ)) + 0.5) * 1e-4
    return dict(sigma=sigma,
                energy=sigma * (rng.random((NR, NAZ)) * 2e-3 + 5e-4),
                h=rng.random((NR, NAZ)) * 0.05 + 0.03)


def T(a):
    return torch.tensor(np.asarray(a), dtype=torch.float64)


def _close(got, ref, rtol=RTOL):
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=rtol,
                                   atol=0.0)


def test_flux_limiter():
    R = np.concatenate([np.linspace(0.0, 4.0, 101), [1e-8, 50.0, 1e4]])
    _close([fld.flux_limiter(T(R))], [j_fld.flux_limiter(jnp.asarray(R))])


@pytest.mark.parametrize("bounds", [("none", "none"),
                                    ("zeroflux", "zerogradient"),
                                    ("zerogradient", "outflow")])
def test_coefficients_and_matrix(fields, bounds):
    js, ts, jg, tg = _solvers(inner_boundary=bounds[0],
                              outer_boundary=bounds[1])
    f = fields
    rho = f["sigma"] / (np.sqrt(2.0 * np.pi) * f["h"])
    temp = f["energy"] / f["sigma"] * 40.0
    ref = js.diffusion_coefficients(jg, jnp.asarray(rho), jnp.asarray(temp))
    got = ts.diffusion_coefficients(tg, T(rho), T(temp))
    _close(got, ref)
    dt = 3e-3
    _close(ts.matrix_elements(tg, T(rho), *got, T(dt)),
           js.matrix_elements(jg, jnp.asarray(rho), *ref, jnp.float64(dt)))
    _close([ts._temperature_boundary(T(temp))],
           [js._temperature_boundary(jnp.asarray(temp))])


@pytest.mark.parametrize("check_interval", [1, 3])
def test_radiative_diffusion_solve(fields, check_interval):
    """The whole substep: the same SOR iteration count and energy."""
    js, ts, jg, tg = _solvers(check_interval=check_interval)
    f = fields
    dt = 5.0
    e_ref, n_ref, _ = js.radiative_diffusion(
        jg, jnp.asarray(f["sigma"]), jnp.asarray(f["energy"]),
        jnp.asarray(f["h"]), jnp.float64(dt))
    e, n, _ = ts.radiative_diffusion(tg, T(f["sigma"]), T(f["energy"]),
                                     T(f["h"]), T(dt))
    assert n == int(n_ref) > 3 * check_interval
    _close([e], [e_ref])


def test_solve_does_not_depend_on_the_block(fields, monkeypatch):
    f = fields
    outs = []
    for block in (1, 7):
        monkeypatch.setattr(fld, "SOR_BLOCK", block)
        _, ts, _, tg = _solvers()
        outs.append(ts.radiative_diffusion(tg, T(f["sigma"]), T(f["energy"]),
                                           T(f["h"]), T(0.05))[:2])
    assert outs[0][1] == outs[1][1]
    assert torch.equal(outs[0][0], outs[1][0])


def test_max_iterations_stop(fields):
    js, ts, jg, tg = _solvers(tolerance=0.0, max_iterations=6)
    f = fields
    e_ref, n_ref, _ = js.radiative_diffusion(
        jg, jnp.asarray(f["sigma"]), jnp.asarray(f["energy"]),
        jnp.asarray(f["h"]), jnp.float64(0.05))
    e, n, _ = ts.radiative_diffusion(tg, T(f["sigma"]), T(f["energy"]),
                                     T(f["h"]), T(0.05))
    assert n == int(n_ref) == 6
    _close([e], [e_ref])


def test_auto_omega_walk(fields):
    js, ts, jg, tg = _solvers(auto_omega=True)
    sj = js.initial_sor_state(jnp.float64)
    st = ts.initial_sor_state(torch.float64)
    _close([st], [sj])
    for n_iter in (40, 30, 35, 35, 1):
        sj = js.adapt_omega(sj, jnp.asarray(n_iter, jnp.int32))
        st = ts.adapt_omega(st, n_iter)
        _close([st], [sj])
    f = fields
    e_ref, n_ref, sj = js.radiative_diffusion(
        jg, jnp.asarray(f["sigma"]), jnp.asarray(f["energy"]),
        jnp.asarray(f["h"]), jnp.float64(0.05), sor_state=sj)
    e, n, st = ts.radiative_diffusion(tg, T(f["sigma"]), T(f["energy"]),
                                      T(f["h"]), T(0.05), sor_state=st)
    assert n == int(n_ref)
    _close([e, st], [e_ref, sj])

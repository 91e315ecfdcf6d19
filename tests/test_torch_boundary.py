"""The boundary menu of fargocpt_torch against the JAX package's
``apply_boundary_conditions``: every name of every variable at each edge,
on seeded float64 fields with a rotating frame, rtol 1e-14. Both sides
evaluate the same expressions from float64 radii; a ghost value the port
takes from the host's radii is the one JAX evaluates on the device."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from fargocpt_tpu.constants import Constants as JConstants
from fargocpt_tpu.grid import Geometry as JGeometry
from fargocpt_tpu.ops import boundary as j_boundary
from fargocpt_tpu.ops.common import prepare_geom as j_prepare_geom
from fargocpt_tpu.params import Physics as JPhysics

from fargocpt_torch.constants import Constants
from fargocpt_torch.grid import Geometry
from fargocpt_torch.ops import boundary
from fargocpt_torch.ops.common import Geom
from fargocpt_torch.params import Physics

NR, NAZ = 24, 16
RTOL = 1e-14
OMEGA = 0.3

CASES = [(var, name, edge)
         for var, names in (("sigma", boundary.SCALAR_BCS),
                            ("energy", boundary.SCALAR_BCS),
                            ("vrad", boundary.VRAD_BCS),
                            ("vaz", boundary.VAZ_BCS))
         for name in names for edge in ("inner", "outer")]


def _phys(**kw):
    base = dict(eos="adiabatic", adiabatic_index=1.4, aspectratio_ref=0.05,
                flaring_index=0.25, sigma0=2.0, sigma_slope=0.5,
                thickness_smoothing=0.6, viscous_outflow_speed=1.3,
                keplerian_radial_inner_factor=0.9,
                keplerian_radial_outer_factor=1.1,
                keplerian_azimuthal_inner_factor=0.97,
                keplerian_azimuthal_outer_factor=1.02,
                composite_inner="individual", composite_outer="individual",
                omega_frame=OMEGA)
    base.update(kw)
    return JPhysics(**base), Physics(**base)


@pytest.fixture(scope="module")
def setup():
    geo = dict(nrad=NR, naz=NAZ, rmin=0.4, rmax=2.5, spacing="Log")
    jg = j_prepare_geom(JGeometry.build(*geo.values()), jnp.float64)
    tg = Geom(Geometry.build(*geo.values()), torch.float64)
    rng = np.random.default_rng(7)
    f = dict(sigma=rng.random((NR, NAZ)) + 0.5,
             energy=rng.random((NR, NAZ)) * 1e-3 + 1e-3,
             vaz=(rng.random((NR, NAZ)) - 0.5) * 0.1 + 1.0,
             vrad=(rng.random((NR + 1, NAZ)) - 0.5) * 0.05)
    ref = {k: v * (1.0 + 0.1 * rng.random(v.shape)) for k, v in f.items()}
    nu = rng.random((NR, NAZ)) * 1e-5 + 1e-6
    return jg, tg, f, ref, nu


@pytest.mark.parametrize("var,name,edge", CASES,
                         ids=[f"{v}-{n}-{e}" for v, n, e in CASES])
def test_boundary_matches_jax(setup, var, name, edge):
    jg, tg, f, ref, nu = setup
    jp, tp = _phys(**{f"bc_{var}_{edge}": name})
    boundary.check_supported(tp)
    vrad = f["vrad"].copy()
    # the outflow rule keeps an inflow at one edge and zeroes it at the
    # other: both signs on both edges
    vrad[2, ::2] = -np.abs(vrad[2, ::2])
    vrad[NR - 2, 1::2] = -np.abs(vrad[NR - 2, 1::2])
    T = lambda a: torch.tensor(a, dtype=torch.float64)  # noqa: E731
    got = boundary.apply_boundary_conditions(
        tp, Constants(), tg, T(f["sigma"]), T(vrad), T(f["vaz"]),
        T(f["energy"]),
        boundary.RefValues(sigma0=T(ref["sigma"]), energy0=T(ref["energy"]),
                           vrad0=T(ref["vrad"]), vaz0=T(ref["vaz"])),
        T(OMEGA), nu=T(nu))
    want = j_boundary.apply_boundary_conditions(
        jp, JConstants(), jg, jnp.asarray(f["sigma"]), jnp.asarray(vrad),
        jnp.asarray(f["vaz"]), jnp.asarray(f["energy"]),
        j_boundary.RefValues(sigma0=jnp.asarray(ref["sigma"]),
                             energy0=jnp.asarray(ref["energy"]),
                             vrad0=jnp.asarray(ref["vrad"]),
                             vaz0=jnp.asarray(ref["vaz"])),
        jnp.float64(OMEGA), nu=jnp.asarray(nu))
    for label, a, b in zip(("sigma", "vrad", "vaz", "energy"), got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=RTOL,
                                   atol=0.0, err_msg=label)
    # the interior is never touched
    k = ("sigma", "vrad", "vaz", "energy").index(var)
    lo, hi = (2, NR - 1) if var == "vrad" else (1, NR - 1)
    src = vrad if var == "vrad" else f[var]
    np.testing.assert_array_equal(got[k].numpy()[lo:hi], src[lo:hi])


def test_viscous_bc_needs_the_viscosity_grid(setup):
    _, tg, f, ref, _ = setup
    _, tp = _phys(bc_vrad_inner="viscous")
    T = lambda a: torch.tensor(a, dtype=torch.float64)  # noqa: E731
    rv = boundary.RefValues(*(T(ref[k]) for k in ("sigma", "energy",
                                                  "vrad", "vaz")))
    with pytest.raises(ValueError, match="viscosity"):
        boundary.apply_boundary_conditions(
            tp, Constants(), tg, T(f["sigma"]), T(f["vrad"]), T(f["vaz"]),
            T(f["energy"]), rv, T(OMEGA))


@pytest.mark.parametrize("side", ["inner", "outer"])
def test_custom_composite_is_in_the_menu(side):
    """The ``custom`` composite is ported: the menu takes it on either
    side, and ``HydroStep`` applies the user's function after the named
    boundaries (tests/test_torch_custom_boundary.py)."""
    _, tp = _phys(**{f"composite_{side}": "custom"})
    boundary.check_supported(tp)


@pytest.mark.parametrize("side", ["inner", "outer"])
def test_center_of_mass_composite_is_in_the_menu(side):
    """The ``centerofmass`` composite is ported (tests/test_torch_binary.py
    holds it against the JAX package): the menu takes it on either side,
    whose ghosts it writes from the bodies (``com_ctx``)."""
    _, tp = _phys(**{f"composite_{side}": "centerofmass"})
    boundary.check_supported(tp)


def test_unknown_name_raises():
    _, tp = _phys(bc_vaz_outer="reflecting")
    with pytest.raises(NotImplementedError, match="reflecting"):
        boundary.check_supported(tp)

"""``CustomBoundaryModule`` (reference src/boundary_conditions/custom.cpp):
fargocpt_torch loads ``custom_boundary(g, sigma, vrad, vaz, energy,
omega_frame)`` from a .py file or an importable module and applies it
after the named boundaries of every boundary call on a ``custom`` side,
as the JAX package does (``fargocpt_tpu/sim.py:55-79, 305-321``).

* a torch module beside a JAX module doing the same arithmetic: both runs
  (tests/test_custom_boundary.py's isothermal disk at 32x16, ten steps)
  agree at rtol 1e-10 (``tests/test_torch_planet.py``'s
  ``assert_states``), and the hook's ghosts are in place;
* an importable module name; a hook set on ``sim.stepper.custom_bc``;
* the errors and the warning: a missing file (FileNotFoundError), a
  module without the function (AttributeError), a ``custom`` side with no
  module (UserWarning).
"""

import sys
import textwrap

import numpy as np
import pytest
import torch

from fargocpt_tpu.config import Config as JConfig
from fargocpt_tpu.sim import Simulation as JSimulation

from fargocpt_torch.config import Config
from fargocpt_torch.sim import Simulation

from test_torch_planet import assert_states

torch.set_num_threads(2)

BASE = {
    "EquationOfState": "Isothermal", "AspectRatio": "0.05",
    "ViscousAlpha": "0.001", "Sigma0": "200 g/cm2",
    "SigmaSlope": "0.5", "ArtificialViscosity": "SN",
    "Nrad": "32", "Naz": "16", "Rmin": "0.4", "Rmax": "2.5",
    "RadialSpacing": "Log",
    "InnerBoundary": "custom", "OuterBoundary": "outflow",
    "Transport": "FARGO", "FirstDT": "1e-3",
    "Nsnapshots": "1", "Nmonitor": "1", "MonitorTimestep": "0.05",
}

JAX_SRC = textwrap.dedent("""
    import jax.numpy as jnp

    def custom_boundary(g, sigma, vrad, vaz, energy, omega_frame):
        sigma = sigma.at[0].set(0.5 * sigma[1] + 1e-6)
        vrad = vrad.at[0:2].set(0.0)
        vaz = vaz.at[0].set(1.0 / jnp.sqrt(g.rb[0, 0])
                            - g.rb[0, 0] * omega_frame)
        return sigma, vrad, vaz, energy
""")

TORCH_SRC = textwrap.dedent("""
    import torch

    def custom_boundary(g, sigma, vrad, vaz, energy, omega_frame):
        r0 = g.rb[0, 0]
        sigma = torch.cat([0.5 * sigma[1:2] + 1e-6, sigma[1:]])
        vrad = torch.cat([torch.zeros_like(vrad[:2]), vrad[2:]])
        ghost = 1.0 / torch.sqrt(r0) - r0 * omega_frame
        vaz = torch.cat([ghost.expand_as(vaz[:1]), vaz[1:]])
        return sigma, vrad, vaz, energy
""")


def _cfg(**over) -> dict:
    return dict(BASE, **over)


def test_custom_module_matches_jax(tmp_path):
    (tmp_path / "bc_jax.py").write_text(JAX_SRC)
    (tmp_path / "bc_torch.py").write_text(TORCH_SRC)
    js = JSimulation(JConfig.from_dict(_cfg(
        CustomBoundaryModule=str(tmp_path / "bc_jax.py"))))
    ts = Simulation(Config.from_dict(_cfg(
        CustomBoundaryModule=str(tmp_path / "bc_torch.py"))), device="cpu")
    assert ts.stepper.custom_bc is not None
    assert_states(ts, js, "initial")
    for _ in range(10):
        dj = js.calculate_time_step()
        dt = ts.calculate_time_step()
        np.testing.assert_allclose(float(dt), dj, rtol=1e-12)
        js.step_once(dj)
        ts.step_once(dt)
    assert_states(ts, js, "after 10 steps")
    f = ts.fields
    np.testing.assert_array_equal(f.sigma[0].numpy(),
                                  0.5 * f.sigma[1].numpy() + 1e-6)
    assert not f.vrad[:2].any()


def test_custom_module_by_import_name(tmp_path, monkeypatch):
    (tmp_path / "bc_named.py").write_text(TORCH_SRC)
    monkeypatch.syspath_prepend(str(tmp_path))
    try:
        ts = Simulation(Config.from_dict(_cfg(
            CustomBoundaryModule="bc_named")), device="cpu")
        ts.step_once(ts.calculate_time_step())
        assert not ts.fields.vrad[:2].any()
    finally:
        sys.modules.pop("bc_named", None)


def test_hook_set_on_the_stepper():
    with pytest.warns(UserWarning, match="CustomBoundaryModule"):
        ts = Simulation(Config.from_dict(_cfg()), device="cpu")

    def hook(g, sigma, vrad, vaz, energy, omega_frame):
        return (torch.cat([torch.full_like(sigma[:1], 0.5), sigma[1:]]),
                vrad, vaz, energy)

    ts.stepper.custom_bc = hook
    ts.step_once(ts.calculate_time_step())
    assert (ts.fields.sigma[0] == 0.5).all()


def test_custom_side_without_a_module_warns_and_runs():
    with pytest.warns(UserWarning, match="no-op"):
        ts = Simulation(Config.from_dict(_cfg()), device="cpu")
    assert ts.stepper.custom_bc is None
    ts.step_once(ts.calculate_time_step())
    assert torch.isfinite(ts.fields.sigma).all()


def test_missing_module_file_raises(tmp_path):
    with pytest.raises(FileNotFoundError, match="CustomBoundaryModule"):
        Simulation(Config.from_dict(_cfg(
            CustomBoundaryModule=str(tmp_path / "absent.py"))), device="cpu")


def test_module_without_the_function_raises(tmp_path):
    (tmp_path / "empty.py").write_text("x = 1\n")
    with pytest.raises(AttributeError, match="custom_boundary"):
        Simulation(Config.from_dict(_cfg(
            CustomBoundaryModule=str(tmp_path / "empty.py"))), device="cpu")

"""Helpers of the long-tail parity tests (tests/test_torch_polytropic.py,
test_torch_sg_bessel.py, test_torch_disk_no.py, test_torch_initial_longtail.py,
test_torch_dust_diffusion.py, test_torch_pvte_lookup.py): one configuration
built by both packages on the CPU in float64 and stepped on the same dt.

``step_pair`` takes each step's dt from the JAX package's
``calculate_time_step`` after holding the port's to it (rtol 1e-12), so a
trajectory that differs only by roundoff is compared on one dt sequence.
``assert_fields`` holds sigma, v_az, the energy and Q+ / Q- to ``rtol``
and v_rad to ``vrad_atol`` of its largest value: the initial steady
viscous drift of v_rad is a finite difference that numpy and XLA round
apart by ~2e-10 (tests/test_torch_slice.py says why).
"""

import numpy as np
import torch

from fargocpt_tpu import config as j_config, sim as j_sim
from fargocpt_tpu.ops import pvte as j_pvte

from fargocpt_torch.config import Config
from fargocpt_torch.ops import pvte
from fargocpt_torch.sim import Simulation

FIELDS = ("sigma", "vrad", "vaz", "energy")
BASE = {
    "EquationOfState": "Ideal", "AdiabaticIndex": "1.4",
    "AspectRatio": "0.05", "FlaringIndex": "0.25", "ViscousAlpha": "0.001",
    "Sigma0": "200 g/cm2", "SigmaSlope": "0.5", "ArtificialViscosity": "SN",
    "Nrad": "32", "Naz": "64", "Rmin": "0.4", "Rmax": "2.5",
    "RadialSpacing": "Log", "InnerBoundary": "outflow",
    "OuterBoundary": "outflow", "Transport": "FARGO", "FirstDT": "0.01",
    "Nsnapshots": "1", "Nmonitor": "1", "MonitorTimestep": "1.0",
}


def build_pair(cfg=None, path=None):
    """(JAX Simulation, port Simulation on the CPU) of a dict or a file."""
    def load(cls):
        return cls.from_file(path) if path else cls.from_dict(dict(cfg))
    return (j_sim.Simulation(load(j_config.Config)),
            Simulation(load(Config), device="cpu"))


def share_port_tables(monkeypatch):
    """Give the JAX package the port's lookup tables (float64, built on the
    CPU), so a step test builds one table, not two; the tables themselves
    are held against each other in tests/test_torch_pvte_lookup.py."""
    monkeypatch.setattr(j_pvte, "lookup_tables", lambda x_mf: tuple(
        t.numpy() for t in pvte.lookup_tables(x_mf, "cpu")))


def step_pair(js, ts, steps: int) -> None:
    for _ in range(steps):
        dj = js.calculate_time_step()
        dt = ts.calculate_time_step()
        np.testing.assert_allclose(float(dt), dj, rtol=1e-12)
        js.step_once(dj)
        ts.step_once(torch.tensor(dj, dtype=torch.float64))
    assert ts.n_hydro_iter == js.n_hydro_iter
    np.testing.assert_allclose(float(ts.time), js.time, rtol=1e-12)


def moved(ts, before: dict) -> dict:
    """How far each field moved from ``before``, over its largest value."""
    out = {}
    for name in FIELDS:
        now = getattr(ts.state.fields, name)
        scale = max(float(now.abs().max()), 1e-300)
        out[name] = float((now - before[name]).abs().max()) / scale
    return out


def snapshot(ts) -> dict:
    return {n: getattr(ts.state.fields, n).clone() for n in FIELDS}


def assert_fields(t_state, j_state, rtol=1e-10, vrad_atol=1e-9,
                  q=True) -> None:
    for name in FIELDS:
        ref = np.asarray(getattr(j_state.fields, name))
        atol = vrad_atol * np.abs(ref).max() if name == "vrad" else 0.0
        np.testing.assert_allclose(getattr(t_state.fields, name).numpy(),
                                   ref, rtol=rtol, atol=atol, err_msg=name)
    for name in ("qplus", "qminus") if q else ():
        ref = np.asarray(getattr(j_state, name))
        np.testing.assert_allclose(getattr(t_state, name).numpy(), ref,
                                   rtol=rtol, atol=1e-10 * np.abs(ref).max(),
                                   err_msg=name)


def assert_bodies(t_state, j_state, rtol=1e-12) -> None:
    for name in ("x", "y", "vx", "vy", "mass"):
        ref = np.asarray(getattr(j_state.nbody, name))
        np.testing.assert_allclose(
            getattr(t_state.nbody, name).numpy(), ref, rtol=rtol,
            atol=rtol * np.abs(ref).max(), err_msg=f"nbody.{name}")

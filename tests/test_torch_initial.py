"""The initial conditions of fargocpt_torch (``initial.build_initial_state``)
against the JAX package's: the spreading ring, the Sod shock tube, the pure
Keplerian start, ``SetSigma0`` and the 1d / 2d profile files of
``SigmaCondition`` / ``EnergyCondition``, float64 on the CPU.

Tolerances: rtol 1e-14 for every field both packages build with the same
numpy expressions; the steady viscous drift of v_rad (where it is not set
to zero) is a 5-point finite difference the JAX package evaluates with
XLA's pow, held to rtol 1e-9 (tests/test_torch_slice.py states why)."""

import numpy as np
import pytest
import torch

from fargocpt_tpu import initial as j_initial, units as j_units
from fargocpt_tpu.config import Config as JConfig
from fargocpt_tpu.constants import Constants as JConstants
from fargocpt_tpu.grid import Geometry as JGeometry
from fargocpt_tpu.params import physics_from_config as j_physics

from fargocpt_torch import initial, units
from fargocpt_torch.config import Config
from fargocpt_torch.constants import Constants
from fargocpt_torch.grid import Geometry
from fargocpt_torch.params import physics_from_config

NR, NAZ = 48, 8
BASE = {"Nrad": str(NR), "Naz": str(NAZ), "Rmin": "0.4", "Rmax": "2.5",
        "AspectRatio": "0.05", "Sigma0": "1e-3", "SigmaSlope": "1.0",
        "FlaringIndex": "0.25", "ViscousAlpha": "1e-3"}


def _both(cfg: dict, nbody: dict | None = None):
    """(fields, sigma0) of both packages for one configuration; ``nbody``
    the bodies' float64 arrays where the conditions read them."""
    out = []
    for cfg_cls, unit_mod, consts, phys_fn, geo_cls, build in (
            (JConfig, j_units, JConstants, j_physics, JGeometry, None),
            (Config, units, Constants, physics_from_config, Geometry,
             initial.build_initial_state)):
        c = cfg_cls.from_dict(dict(cfg))
        if int(cfg.get("ShockTube", 0)) == 2:
            un, k = unit_mod.pvte_shock_tube_units(), consts.shock_tube()
        elif int(cfg.get("ShockTube", 0)):
            un, k = unit_mod.shock_tube_units(), consts.shock_tube()
        else:
            un = unit_mod.Units.from_config_strings("1.0", "1.0", None,
                                                    None)
            k = consts.from_units(un)
        c.set_units(un)
        phys = phys_fn(c, un, dtype="float64")
        geo = geo_cls.from_config(c)
        if build is None:
            st, phys = j_initial.build_initial_state(phys, k, geo,
                                                     nbody=nbody)
            fields = {n: np.asarray(getattr(st, n))
                      for n in ("sigma", "vrad", "vaz", "energy")}
        else:
            st, phys = build(phys, k, geo, nbody=nbody, dtype=torch.float64,
                             device="cpu")
            fields = {n: getattr(st, n).numpy()
                      for n in ("sigma", "vrad", "vaz", "energy")}
        out.append((fields, phys.sigma0))
    return out


def _assert_equal(cfg, vrad_rtol=1e-14, nbody=None):
    (jf, js0), (tf, ts0) = _both(cfg, nbody)
    for name in ("sigma", "vaz", "energy", "vrad"):
        rtol = vrad_rtol if name == "vrad" else 1e-14
        np.testing.assert_allclose(tf[name], jf[name], rtol=rtol, atol=0.0,
                                   err_msg=name)
    assert ts0 == pytest.approx(js0, rel=1e-14)
    return tf, ts0


def test_spreading_ring_with_set_sigma0():
    """The spreading_ring golden's IC: the Speith & Kley ring, floored,
    renormalised to DiskMass (SetSigma0), isothermal (zero energy)."""
    tf, s0 = _assert_equal(dict(
        BASE, EquationOfState="Isothermal", AdiabaticIndex="1.0",
        SpreadingRing="Yes", SetSigma0="Yes", DiskMass="1.0",
        SigmaFloor="1e-8", ConstantViscosity="4.77e-5", ViscousAlpha="0.0",
        InitializeVradialZero="Yes", Rmin="0.2", Rmax="1.8"))
    assert (tf["energy"] == 0.0).all() and (tf["vrad"] == 0.0).all()
    # the ring holds DiskMass over the active rings
    geo = Geometry.build(NR, NAZ, 0.2, 1.8, "Log")
    mass = (tf["sigma"][1:-1] * geo.surf[1:-1, None]).sum()
    assert mass == pytest.approx(1.0, rel=1e-13)
    assert s0 != 1e-3


def test_shock_tube():
    """ShockTube 1: the Sod states, the jump half a unit above the inner
    cell centre; the velocities from the standard path."""
    tf, _ = _assert_equal(dict(
        BASE, ShockTube="1", EquationOfState="Ideal", AdiabaticIndex="1.4",
        Rmin="1000.0", Rmax="1001.0", RadialSpacing="Arithmetic",
        AspectRatio="1.0", FlaringIndex="0.5", ViscousAlpha="0.0",
        SigmaSlope="0.0", Nrad="100", Naz="2"), vrad_rtol=1e-9)
    assert set(np.unique(tf["sigma"])) == {0.125, 1.0}
    assert set(np.unique(tf["energy"])) == {0.25, 2.5}


@pytest.mark.parametrize("eos", ["Ideal", "Isothermal"])
def test_pure_keplerian(eos):
    tf, _ = _assert_equal(dict(BASE, EquationOfState=eos,
                               InitializePureKeplerian="Yes"))
    assert (tf["energy"] == 0.0).all() == (eos == "Isothermal")


@pytest.mark.parametrize("eos", ["Ideal", "Isothermal"])
def test_set_sigma0_power_law(eos):
    """SetSigma0 on the power-law disk: sigma (and an ideal gas's energy)
    scaled so the active rings hold DiskMass."""
    _assert_equal(dict(BASE, EquationOfState=eos, SetSigma0="Yes",
                       DiskMass="0.01", InitializeVradialZero="Yes"))


@pytest.mark.parametrize("kind", ["1d", "2d"])
@pytest.mark.parametrize("which", ["Sigma", "Energy", "both"])
def test_profile_files(tmp_path, kind, which):
    """SigmaCondition / EnergyCondition from a file: a [radius, value]
    profile spline-interpolated onto Rmed, or a whole (NR, NAZ) grid."""
    geo = Geometry.build(NR, NAZ, 0.4, 2.5, "Log")
    rng = np.random.default_rng(3)
    cfg = dict(BASE, EquationOfState="Ideal", InitializeVradialZero="Yes")
    for name in (("Sigma", "Energy") if which == "both" else (which,)):
        path = tmp_path / f"{name}.dat"
        if kind == "1d":
            r = np.linspace(0.3, 2.7, 64)
            rows = np.stack([r, 1e-3 * r ** -1.0 * (1 + 0.1 * np.sin(5 * r)),
                             r, r], axis=1)
            rows.astype(np.float64).tofile(path)
        else:
            (rng.random((NR, NAZ)) * 1e-4 + 1e-4).tofile(path)
        cfg[f"{name}Condition"] = kind
        cfg[f"{name}Filename"] = str(path)
    tf, _ = _assert_equal(cfg)
    if which in ("Sigma", "both") and kind == "2d":
        np.testing.assert_array_equal(
            tf["sigma"], np.fromfile(tmp_path / "Sigma.dat").reshape(NR, NAZ))
    assert geo.nrad == tf["sigma"].shape[0]


# a star and a companion of 0.3 on a circular orbit at r = 1.2, whose
# Roche lobe (0.34) reaches past the closest a cell may be to it (Rmin / 3)
TWO_BODIES = {"x": np.array([0.0, 1.2]), "y": np.array([0.0, 0.0]),
              "vx": np.array([0.0, 0.0]),
              "vy": np.array([0.0, np.sqrt(1.3 / 1.2)]),
              "mass": np.array([1.0, 0.3])}


@pytest.mark.parametrize("extra,feature", [
    ({"ShockTube": "2"}, "PVTE shock tube"),
    ({"RandomSigma": "Yes"}, "SigmaRandomize"),
    ({"CentrifugalBalance": "Yes"}, "CentrifugalBalance"),
    ({"SecondaryDisk": "Yes"}, "secondary disk"),
])
def test_initial_conditions_outside_the_slice_raise(extra, feature):
    """The initial conditions once outside the port's slice, now ported:
    the PVTE shock tube, ``RandomSigma``, ``CentrifugalBalance`` and the
    disk around the secondary equal the JAX package's (rtol 1e-14; v_rad,
    the viscous drift, 1e-9)."""
    cfg = dict(BASE, EquationOfState="Ideal", FeatureSize="0.05",
               ProfileCutoffPointOuter="0.8", ProfileCutoffWidthOuter="0.1",
               **extra)
    secondary = "SecondaryDisk" in extra
    tf, _ = _assert_equal(cfg, vrad_rtol=1e-9,
                          nbody=TWO_BODIES if secondary else None)
    _, (plain, _) = _both(dict(cfg, SecondaryDisk="No", RandomSigma="No",
                               CentrifugalBalance="No", ShockTube="0"))
    if "ShockTube" in extra:
        assert set(np.unique(tf["sigma"])) == {0.125, 1.0}
        assert tf["energy"].max() == 10.361627466581034
    elif "CentrifugalBalance" in extra:
        assert not np.array_equal(tf["vaz"], plain["vaz"])
    elif secondary:
        # on 8 sectors no v_az interface lies in the Roche lobe
        assert not np.array_equal(tf["vrad"], plain["vrad"])
        assert (tf["sigma"] > 1.5 * plain["sigma"]).any()
    else:
        assert not np.array_equal(tf["sigma"], plain["sigma"])

"""Simulation parameters parsed from YAML config.

Replaces the reference's ~283 ``parameters::*`` globals
(src/parameters.cpp, src/Interpret.cpp). All values live in a frozen,
hashable dataclass so the jitted step functions can close over them as
compile-time constants; reconfiguring triggers a recompile (the reference
recompiles, too — these are all fixed for a run).

Only behavior-bearing parameters live here; output cadence & writer flags
are parsed in :mod:`fargocpt_tpu.sim`.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, replace

from . import units as u
from .config import Config

# EoS modes
ISOTHERMAL = "isothermal"
ADIABATIC = "adiabatic"
POLYTROPIC = "polytropic"

# artificial viscosity modes
ARTVISC_NONE = "none"
ARTVISC_SN = "sn"
ARTVISC_TW = "tw"

EULER = "euler"
LEAPFROG = "leapfrog"


@dataclass(frozen=True)
class Physics:
    """Static physics configuration (hashable; closed over by jit)."""

    # EoS (reference src/Interpret.cpp:393-557)
    eos: str = ISOTHERMAL
    adiabatic_index: float = 1.4
    polytropic_constant: float = 0.0
    mu: float = 1.0
    variable_gamma: bool = False
    hydrogen_mass_fraction: float = 0.75
    # reference-exact 1000x1000 (rho, e) lookup-table quantization of
    # (gamma_eff, mu, gamma1) instead of the default in-graph bisection
    # (reference src/pvte_law.cpp:25-440 always uses the tables)
    pvte_lookup_table: bool = False

    # geometry of the temperature profile
    aspectratio_ref: float = 0.05
    aspectratio_mode: int = 0
    flaring_index: float = 0.0

    # density profile
    sigma0: float = 1.0
    sigma_slope: float = 0.0
    sigma_floor: float = 1e-9
    sigma_adjust: bool = False
    sigma_diskmass: float = 0.01

    # temperature limits (code units)
    minimum_temperature: float = 0.0
    maximum_temperature: float = 1e300

    # viscosity
    constant_viscosity: float = 0.0
    viscous_alpha: float = 0.0
    alpha_mode: int = 0
    alpha_cold: float = 0.01
    alpha_hot: float = 0.1
    radial_viscosity_factor: float = 1.0
    stabilize_viscosity: int = 0

    # artificial viscosity
    artificial_viscosity: str = ARTVISC_SN
    artificial_viscosity_factor: float = 1.41
    artificial_viscosity_dissipation: bool = True

    # heating / cooling
    heating_viscous: bool = True
    heating_viscous_factor: float = 1.0
    heating_star: bool = False
    cooling_beta_enabled: bool = False
    cooling_beta: float = 1.0
    cooling_beta_ramp_up: float = 0.0
    cooling_beta_reference: bool = False
    cooling_beta_model: bool = False
    cooling_beta_floor: bool = False
    # Ziampras et al. 2023 local beta: "no" | "surf" | "mid" | "tot"
    cooling_beta_method: str = "no"
    cooling_surface_enabled: bool = False
    surface_cooling_factor: float = 1.0
    cooling_scurve_enabled: bool = False
    scurve_kimura: bool = True   # Kimura+2020 vs Ichikawa&Osaki 1992
    opacity_mode: str = "lin"
    kappa_const: float = 1.0
    tau_factor: float = 0.5
    tau_min: float = 0.01
    kappa_factor: float = 1.0
    density_factor: float = math.sqrt(2.0 * math.pi)

    # radiative diffusion (FLD) — wired in ops/fld.py
    radiative_diffusion: bool = False
    fld_tolerance: float = 1e-10
    fld_max_iterations: int = 50000
    fld_omega: float = 1.5
    fld_auto_omega: bool = False
    fld_inner_boundary: str = "none"
    fld_outer_boundary: str = "none"
    # SOR double-sweeps per convergence-norm check (repo extension;
    # >1 is tolerance-equivalent — the solve can only stop LATER — and
    # saves the per-iteration full-grid reduction on TPU)
    fld_check_interval: int = 1
    # RadiativeDiffusionTest1D: pin the flux limiter at its optically-thick
    # value 1/3 (reference src/fld.cpp:129,:234 sets constant_fluxlimiter)
    fld_constant_fluxlimiter: bool = False

    # self-gravity
    self_gravity: bool = False
    self_gravity_mode: str = "besselkernel"
    # kernel refresh cadence (reference src/parameters.cpp:715-716)
    sg_kernel_update_interval: int = 20
    sg_kernel_aspectratio_threshold: float = 0.001
    thickness_smoothing_sg: float = 0.6

    # gravity smoothing
    thickness_smoothing: float = 0.6
    compatibility_smoothing_planetloc: bool = False
    compatibility_no_star_smoothing: bool = False
    body_force_from_potential: bool = True

    # transport / integrator
    fast_transport: bool = True
    flux_limiter_type: int = 0   # 0 = van Leer, 1 = MC
    hydro_integrator: str = EULER

    # CFL
    cfl: float = 0.5
    cfl_max_var: float = 1.1
    heating_cooling_cfl_limit: float = 10.0

    # frame
    omega_frame: float = 0.0
    corotating: bool = False
    corotation_reference_body: int = 1
    indirect_term_mode: int = 0
    indirect_term_disk_on_disk: bool = False
    # disk-accel on body 0 zeroed: orbit-in-fixed-potential test mode
    # (reference src/parameters.cpp:790, Pframeforce.cpp:218-221)
    planet_orbit_disk_test: bool = False
    # alternate f=1-r/R normalization of the viscous accretion stencil
    # (reference src/parameters.cpp:844, accretion.cpp:360-377)
    visc_accret_massflow_test: bool = False
    # snap planet semi-major axes to cell-center radii at init
    # (reference src/Interpret.cpp:583, nbody/planetary_system.cpp:198-204)
    cic_planet: bool = False
    disk_feedback: bool = True
    # N-body integrator: ias15 (reference REBOUND default), rk4, or the
    # legacy Cash-Karp rk5 (reference src/RungeKutta.cpp:12-92, dead code
    # there; corrected tableau here — see nbody/system.py)
    nbody_integrator: str = "ias15"

    # initialization
    shock_tube: int = 0
    spreading_ring: bool = False
    initialize_pure_keplerian: bool = False
    initialize_vradial_zero: bool = False
    imposed_disk_drift: float = 0.0
    profile_cutoff_outer: bool = False
    profile_cutoff_point_outer: float = 1e300
    profile_cutoff_width_outer: float = 1.0
    profile_cutoff_inner: bool = False
    profile_cutoff_point_inner: float = 0.0
    profile_cutoff_width_inner: float = 1.0
    center_mass_density_correction_factor: float = 1.0

    # boundaries (per-variable names; resolved in ops/boundary.py)
    composite_inner: str = "individual"
    composite_outer: str = "individual"
    bc_sigma_inner: str = "zerogradient"
    bc_sigma_outer: str = "zerogradient"
    bc_energy_inner: str = "zerogradient"
    bc_energy_outer: str = "zerogradient"
    bc_vrad_inner: str = "zerogradient"
    bc_vrad_outer: str = "zerogradient"
    bc_vaz_inner: str = "keplerian"
    bc_vaz_outer: str = "keplerian"
    keplerian_azimuthal_inner_factor: float = 1.0
    keplerian_azimuthal_outer_factor: float = 1.0
    # reference default 0.1 (src/boundary_conditions/config.cpp:221,:255)
    keplerian_radial_inner_factor: float = 0.1
    keplerian_radial_outer_factor: float = 0.1
    viscous_outflow_speed: float = 1.0
    domegadr_zero: bool = False

    # damping zones (reference src/boundary_conditions/damping.cpp)
    damping: bool = False
    damping_inner_limit: float = 1.05
    damping_outer_limit: float = 0.95
    damping_time_factor: float = 1.0
    # radius whose Omega_K sets the OUTER damping timescale (reference
    # src/boundary_conditions/damping.cpp:199-205); 0.0 = unset -> RMAX
    damping_time_radius_outer: float = 0.0
    damping_energy_inner: str = "none"
    damping_vradial_inner: str = "none"
    damping_vazimuthal_inner: str = "none"
    damping_surface_density_inner: str = "none"
    damping_energy_outer: str = "none"
    damping_vradial_outer: str = "none"
    damping_vazimuthal_outer: str = "none"
    damping_surface_density_outer: str = "none"

    # accretion onto planets (reference src/accretion.cpp)
    accretion_radius_fraction: float = 1.0

    # Roche-lobe overflow stream (reference
    # src/boundary_conditions/mass_overflow.cpp)
    rochelobe_overflow: bool = False
    rof_planet: int = 1
    rof_temperature: float = 0.0
    rof_mdot: float = 0.0
    rof_rampingtime: float = 30.0
    rof_gamma: float = 0.5
    rof_variable_transfer: bool = False
    rof_averaging_time: float = 10.0     # donor orbits (ROFaveragingtime)
    write_ecc_changes: bool = False      # WriteEccentricityChange

    # misc
    calculate_disk: bool = True
    viscous_accretion: bool = False
    integrate_particles: bool = False
    keep_mass_constant: bool = False

    # binary quadrupole correction of the initial/boundary v_az
    # (reference src/parameters.cpp:667)
    vaz_quadrupole_support: bool = False

    # initial-condition extensions (reference src/parameters.cpp:600-760,
    # src/init.cpp:255-341)
    sigma_condition: str = "profile"      # profile | nbody | 1d | 2d
    sigma_filename: str = ""
    energy_condition: str = "profile"
    energy_filename: str = ""
    sigma_randomize: bool = False
    sigma_random_factor: float = 0.1
    sigma_feature_size: float = 0.0
    random_seed: int = 0
    cbd_ring: bool = False                # circumbinary Gaussian ring
    cbd_ring_position: float = 4.5
    cbd_ring_width: float = 0.6
    cbd_decay_width: float = 0.84
    cbd_decay_exponent: float = 0.75
    cbd_ring_enhancement_factor: float = 2.5
    secondary_disk: bool = False
    centrifugal_balance: bool = False

    # distributed (shard-local) snapshot writes: each process writes only
    # its addressable shard rows — the analog of the reference's MPI-IO
    # slab output (src/polargrid.cpp:135-186)
    distributed_output: bool = False

    # monitoring / diagnostics (reference src/parameters.cpp:243-380)
    write_massflow: bool = False          # accumulate MassFlow grid
    write_gas_torques: bool = False
    write_alpha_grav_mean: bool = False
    write_alpha_reynolds_mean: bool = False
    # scalar-quantities integration radius (reference parameters.cpp:549-556,
    # QuantitiesRadiusLimit); 0.0 = unset -> 2*RMAX, negative -> primary
    # Roche lobe (output.cpp:367-374)
    quantities_radius_limit: float = 0.0
    # fraction of total mass defining the disk radius diagnostic
    # (reference parameters.cpp:546, Kley et al. 2008 use 0.99)
    disk_radius_mass_fraction: float = 0.99
    # planets gain accreted mass/momentum even without disk feedback
    # (reference accretion.cpp:207,319,466)
    accrete_without_disk_feedback: bool = False
    # disk-on-planet force subtracts the axisymmetric background
    # (reference Force.cpp:64-66; default YES when self-gravity is off,
    # parameters.cpp:732)
    correct_disk_selfgravity: bool = False
    # Q+/Q- are only snapshotted when exact restarts are requested
    # (reference output.cpp:259, parameters.cpp:342)
    bitwise_exact_restarting: bool = False
    # global switch for the 1-D radial profile outputs
    # (reference parameters.cpp:242)
    do_write_1d: bool = True
    # prognostic-field output gates (reference src/parameters.cpp:243-250)
    write_density: bool = True
    write_velocity: bool = True
    write_energy: bool = True
    write_qplus: bool = False
    write_qminus: bool = False
    write_tau: bool = False
    write_sg_accel_rad: bool = False
    write_sg_accel_azi: bool = False
    write_radial_luminosity: bool = False
    write_radial_dissipation: bool = False
    write_disk_quantities: bool = True
    write_default_values: bool = False
    # runtime-log throttles (reference logging.cpp:214-235); this rebuild
    # logs at monitor boundaries (the step loop is on-device), so these act
    # as minimum gaps between monitor-boundary log lines
    log_after_steps: int = 0
    log_after_real_seconds: float = 600.0       # adv/visc/grav torque grids
    write_torques: bool = False           # per-planet torque 1D profiles
    write_lightcurves: bool = False
    lightcurves_radii: tuple = ()
    snapshot_fields: tuple = ()           # extra Write* 2-D output fields
    hydro_center_mass: float = 1.0

    # numerical precision of the state arrays ("float64" or "float32")
    dtype: str = "float64"

    @property
    def is_adiabatic(self) -> bool:
        return self.eos == ADIABATIC

    @property
    def is_polytropic(self) -> bool:
        return self.eos == POLYTROPIC

    @property
    def is_isothermal(self) -> bool:
        return self.eos == ISOTHERMAL

    def with_(self, **kw) -> "Physics":
        return replace(self, **kw)


def _fit_isothermal_constants(cfg: Config) -> tuple[float, float]:
    """Polytropic (K, gamma) matching the locally-isothermal pressure
    profile (reference src/Interpret.cpp:38-53 get_polytropic_constants):
    comparing P_poly = K Sigma^gamma with P_iso = Sigma cs^2 for
    Sigma = Sigma0 r^-p, cs = h vK r^F gives
    gamma = (-1 - p + 2F)/(-p), K = h^2 Sigma0^(1-gamma)."""
    p = cfg.get("SigmaSlope", 0.0, type=float)
    flare = cfg.get("FlaringIndex", 0.0, type=float)
    h = cfg.get("AspectRatio", 0.05, type=float)
    sigma0 = cfg.get("Sigma0", 1.0, dim=u.DIM_SURFACE_DENSITY, type=float)
    gamma = (-1.0 - p + 2.0 * flare) / (-p)
    return h * h * sigma0 ** (1.0 - gamma), gamma


def _is_fit_isothermal(raw) -> bool:
    return str(raw).strip().lower().replace("_", " ") == "fit isothermal"


def _parse_eos(cfg: Config) -> tuple[str, float]:
    eos = cfg.get_lowercase("EquationOfState", "Isothermal")
    gamma_raw = cfg.get_raw("AdiabaticIndex", 1.4)
    if _is_fit_isothermal(gamma_raw):
        # only valid for polytropic EoS (reference Interpret.cpp:429-436
        # dies for ideal/PVTE)
        if eos not in ("polytropic", "polytrop", "poly"):
            raise ValueError(
                "AdiabaticIndex=FIT_ISOTHERMAL is only available for the "
                "polytropic equation of state")
        _, gamma = _fit_isothermal_constants(cfg)
    else:
        gamma = cfg.get("AdiabaticIndex", 1.4, type=float)
    # deprecated 'Adiabatic yes/no' flag (reference
    # src/Interpret.cpp:360-392): honored with a warning when
    # EquationOfState is absent
    if "EquationOfState" not in cfg and "Adiabatic" in cfg:
        import warnings
        flag = cfg.get_flag("Adiabatic", False)
        warnings.warn(
            "'Adiabatic: {}' is deprecated; use 'EquationOfState: {}'"
            .format("yes" if flag else "no",
                    "Adiabatic" if flag else "Isothermal"))
        eos = "adiabatic" if flag else "isothermal"
    if eos in ("isothermal", "iso"):
        return ISOTHERMAL, gamma
    if eos in ("adiabatic", "ideal"):
        if gamma == 1.0:
            return ISOTHERMAL, gamma
        return ADIABATIC, gamma
    if eos in ("polytropic", "polytrop", "poly"):
        # reference name aliases (src/Interpret.cpp:497-499)
        return POLYTROPIC, gamma
    if eos == "pvte":
        # variable-gamma ideal EoS (reference src/Interpret.cpp:455-492)
        if gamma == 1.0:
            gamma = 7.0 / 5.0
        return ADIABATIC, gamma
    raise ValueError(f"unknown EquationOfState {eos!r}")


def _parse_polytropic_constant(cfg: Config, eos: str) -> float:
    """PolytropicConstant, honoring FIT_ISOTHERMAL (reference
    src/Interpret.cpp:525-545).  Always consulted — the reference calls
    get for the default regardless of EoS (:495) — but only parsed as a
    number when the EoS is polytropic, so 'FIT_ISOTHERMAL' in a
    non-polytropic setup (e.g. setups/PDS70.yml) is accepted and
    ignored."""
    raw = cfg.get_raw("PolytropicConstant", 0.0)
    if _is_fit_isothermal(raw):
        if eos != POLYTROPIC:
            return 0.0
        k, _ = _fit_isothermal_constants(cfg)
        return k
    if eos != POLYTROPIC:
        try:
            return float(raw)
        except (TypeError, ValueError):
            return 0.0
    return cfg.get("PolytropicConstant", 12.753, type=float)


def _parse_artvisc(cfg: Config) -> str:
    s = cfg.get_lowercase("ArtificialViscosity", "SN")
    if s.startswith("n"):
        return ARTVISC_NONE
    if s.startswith("s"):
        return ARTVISC_SN
    if s.startswith("t"):
        return ARTVISC_TW
    raise ValueError(f"unknown ArtificialViscosity {s!r}")


def _parse_bcs(cfg: Config) -> dict:
    """Composite -> per-variable expansion
    (reference src/boundary_conditions/config.cpp:345-432)."""
    out: dict[str, str] = {}

    def expand(side: str) -> dict[str, str]:
        comp = cfg.get_lowercase(f"{side}Boundary", "individual")
        names = {"sigma": "", "energy": "", "vrad": "", "vaz": ""}
        if comp == "individual":
            pass
        elif comp == "zerogradient":
            names.update(sigma="zerogradient", energy="zerogradient",
                         vrad="zerogradient")
        elif comp == "outflow":
            names.update(sigma="zerogradient", energy="zerogradient",
                         vrad="outflow")
        elif comp == "viscous":
            names.update(sigma="zerogradient", energy="zerogradient",
                         vrad="viscous")
        elif comp == "reflecting":
            names.update(sigma="zerogradient", energy="zerogradient",
                         vrad="reflecting")
        elif comp == "reference":
            names.update(sigma="reference", energy="reference",
                         vrad="reference")
        elif comp == "diskmodel":
            # per-variable diskmodel values for the scalars (reference
            # src/boundary_conditions/config.cpp:102-176)
            names.update(sigma="diskmodel", energy="diskmodel",
                         vrad="zerogradient")
        elif comp in ("centerofmass", "custom"):
            names.update(sigma="none", energy="none", vrad="none", vaz="none")
        else:
            raise ValueError(f"unknown {side}Boundary {comp!r}")

        def individual(key: str, inferred: str, default_if_unset: str) -> str:
            s = cfg.get_lowercase(key, "infer")
            if s == "infer":
                return inferred if inferred else default_if_unset
            return s

        side_l = side.lower()
        out[f"composite_{side_l}"] = comp
        return {
            f"bc_sigma_{side_l}": individual(f"{side}BoundarySigma", names["sigma"], "zerogradient"),
            f"bc_energy_{side_l}": individual(f"{side}BoundaryEnergy", names["energy"], "zerogradient"),
            f"bc_vrad_{side_l}": individual(f"{side}BoundaryVrad", names["vrad"], "zerogradient"),
            f"bc_vaz_{side_l}": individual(f"{side}BoundaryVazi", names["vaz"], "keplerian"),
            f"_composite_energy_{side_l}": names["energy"],
        }

    out.update(expand("Inner"))
    out.update(expand("Outer"))

    # Reference quirk, replicated verbatim (config.cpp:147): energy_inner()
    # calls get_type("InnerBoundaryEnergy", energy_OUTER_name), so the
    # INNER energy BC's composite fallback is the OUTER side's name — with
    # e.g. OuterBoundary=centerofmass ("none") and no explicit
    # InnerBoundaryEnergy, the inner energy ghost is never written even
    # though the inner composite implies zerogradient (and the reference
    # log misleadingly prints zerogradient).  get_type also MUTATES the
    # fallback: an explicit InnerBoundaryEnergy becomes the outer
    # fallback for energy_outer() (config.cpp:171) unless
    # OuterBoundaryEnergy is itself explicit.
    exp_in = cfg.get_lowercase("InnerBoundaryEnergy", "infer")
    exp_out = cfg.get_lowercase("OuterBoundaryEnergy", "infer")
    outer_name = out.pop("_composite_energy_outer")
    out.pop("_composite_energy_inner")
    if exp_in == "infer":
        out["bc_energy_inner"] = outer_name if outer_name else "zerogradient"
    else:
        outer_name = exp_in
    if exp_out == "infer":
        out["bc_energy_outer"] = outer_name if outer_name else "zerogradient"
    return out


def physics_from_config(cfg: Config, un: u.Units, dtype: str = "float64") -> Physics:
    eos, gamma = _parse_eos(cfg)
    bcs = _parse_bcs(cfg)

    # hard errors on removed/renamed keys, matching the reference's die()
    # calls (src/parameters.cpp:689, src/boundary_conditions/damping.cpp:259)
    if cfg.contains("cvnr"):
        raise ValueError(
            "Parameter CVNR has been renamed to ArtificialViscosityFactor")
    for dep in ("DampingEnergy", "DampingSurfaceDensity", "DampingVRadial",
                "DampingVAzimuthal"):
        if cfg.contains(dep.lower()):
            raise ValueError(
                f"{dep} is deprecated: use {dep}Inner and {dep}Outer")

    self_gravity = cfg.get_flag("SelfGravity", False)
    it_dod = cfg.get_lowercase("IndirectTermDiskOnDisk", "auto")
    if it_dod == "auto":       # reference src/parameters.cpp:809-824
        indirect_disk_on_disk = self_gravity
    elif it_dod in ("yes", "true", "1"):
        indirect_disk_on_disk = True
    elif it_dod in ("no", "false", "0"):
        indirect_disk_on_disk = False
    else:
        raise ValueError(
            f"invalid IndirectTermDiskOnDisk choice {it_dod!r}")

    surface_cooling = cfg.get_lowercase("SurfaceCooling", "No")
    cooling_surface_enabled = surface_cooling in ("yes", "thermal")
    cooling_scurve_enabled = surface_cooling == "scurve"

    beta_ref = cfg.get_lowercase("CoolingBetaReference", "Zero")

    transport_fast = cfg.get_lowercase("Transport", "Fast")[:1] == "f"
    integ = cfg.get_lowercase("Integrator", "Euler")
    hydro_integrator = LEAPFROG if integ.startswith("l") else EULER

    flux_limiter = cfg.get_lowercase("FluxLimiter", "VanLeer")
    flux_limiter_type = 1 if flux_limiter in ("mc", "monotonizedcentral") else 0

    frame = cfg.get_lowercase("Frame", "F")
    corotating = frame.startswith("c") or frame.startswith("g")

    # Temperature0 overrides the aspect ratio (reference
    # src/Interpret.cpp:193-197): h0 = sqrt(T0 * R / mu)
    aspectratio_ref = cfg.get("AspectRatio", 0.05, type=float)
    t0_code = cfg.get("Temperature0", -1.0, dim=u.DIM_TEMPERATURE, type=float)
    if t0_code > 0.0:
        from .constants import Constants
        c_tmp = Constants.from_units(un)
        mu_val = cfg.get("mu", 1.0, type=float)
        aspectratio_ref = math.sqrt(t0_code * c_tmp.R / mu_val)

    return Physics(
        eos=eos,
        adiabatic_index=gamma,
        variable_gamma=(cfg.get_lowercase("EquationOfState", "Isothermal")
                        == "pvte"),
        hydrogen_mass_fraction=cfg.get("HydrogenMassFraction", 0.75,
                                       type=float),
        pvte_lookup_table=cfg.get_flag("PVTELookupTable", False),
        polytropic_constant=_parse_polytropic_constant(cfg, eos),
        mu=cfg.get("mu", 1.0, type=float),
        aspectratio_ref=aspectratio_ref,
        aspectratio_mode=cfg.get("AspectRatioMode", 0, type=int),
        flaring_index=cfg.get("FlaringIndex", 0.0, type=float),
        sigma0=cfg.get("Sigma0", 1.0, dim=u.DIM_SURFACE_DENSITY, type=float),
        sigma_slope=cfg.get("SigmaSlope", 0.0, type=float),
        sigma_floor=cfg.get("SigmaFloor", 1e-9, type=float),
        sigma_adjust=cfg.get_flag("SetSigma0", False),
        sigma_diskmass=cfg.get("DiskMass", 0.01, dim=u.DIM_MASS, type=float),
        minimum_temperature=cfg.get("MinimumTemperature", 3.0 / un.Temp0,
                                    dim=u.DIM_TEMPERATURE, type=float),
        maximum_temperature=cfg.get("MaximumTemperature", 1e300,
                                    dim=u.DIM_TEMPERATURE, type=float),
        constant_viscosity=cfg.get("ConstantViscosity", 0.0,
                                   dim=u.DIM_KINEMATIC_VISCOSITY, type=float),
        viscous_alpha=cfg.get("ViscousAlpha", 0.0, type=float),
        alpha_mode=cfg.get("AlphaMode", 0, type=int),
        alpha_cold=cfg.get("AlphaCold", 0.01, type=float),
        alpha_hot=cfg.get("AlphaHot", 0.1, type=float),
        radial_viscosity_factor=cfg.get("RadialViscosityFactor", 1.0, type=float),
        stabilize_viscosity=cfg.get("StabilizeViscosity", 0, type=int),
        artificial_viscosity=_parse_artvisc(cfg),
        artificial_viscosity_factor=cfg.get("ArtificialViscosityFactor", 1.41, type=float),
        artificial_viscosity_dissipation=cfg.get_flag("ArtificialViscosityDissipation", True),
        heating_viscous=cfg.get_flag("HeatingViscous", True),
        heating_viscous_factor=cfg.get("HeatingViscousFactor", 1.0, type=float),
        heating_star=cfg.get_flag("HeatingStar", False),
        # the reference reads CoolingBetaLocal then unconditionally
        # overwrites the flag with CoolingBetaZiampras2023
        # (src/parameters.cpp:449-451, an upstream quirk); the sane intent
        # -- either key enables beta cooling -- is used here
        cooling_beta_enabled=(cfg.get_flag("CoolingBetaLocal", False)
                              or cfg.get_flag("CoolingBetaZiampras2023",
                                              False)),
        cooling_beta_method=cfg.get_lowercase(
            "CoolingBetaZiampras2023Method", "no"),
        cooling_beta=cfg.get("CoolingBeta", 1.0, type=float),
        cooling_beta_ramp_up=cfg.get("CoolingBetaRampUp", 0.0, dim=u.DIM_TIME, type=float),
        cooling_beta_reference=(beta_ref == "reference"),
        cooling_beta_model=(beta_ref == "model"),
        cooling_beta_floor=(beta_ref == "floor"),
        cooling_surface_enabled=cooling_surface_enabled,
        surface_cooling_factor=cfg.get("CoolingRadiativeFactor", 1.0, type=float),
        cooling_scurve_enabled=cooling_scurve_enabled,
        scurve_kimura=cfg.get_lowercase("ScurveType", "kimura") == "kimura",
        opacity_mode=cfg.get_lowercase("Opacity", "Lin"),
        # dimensioned: opacity L0^2/M0 (reference src/parameters.cpp:444)
        kappa_const=cfg.get("KappaConst", 1.0, dim=u.DIM_OPACITY,
                            type=float),
        tau_factor=cfg.get("TauFactor", 0.5, type=float),
        tau_min=cfg.get("TauMin", 0.01, type=float),
        kappa_factor=cfg.get("KappaFactor", 1.0, type=float),
        density_factor=cfg.get("DensityFactor", math.sqrt(2.0 * math.pi), type=float),
        radiative_diffusion=cfg.get_flag("RadiativeDiffusion", False),
        fld_tolerance=cfg.get("RadiativeDiffusionTolerance", 1e-10,
                              dim=u.DIM_TEMPERATURE, type=float),
        fld_max_iterations=cfg.get("RadiativeDiffusionMaxIterations", 50000,
                                   type=int),
        fld_omega=cfg.get("RadiativeDiffusionOmega", 1.5, type=float),
        fld_auto_omega=cfg.get_flag("RadiativeDiffusionAutoOmega", False),
        fld_check_interval=cfg.get("RadiativeDiffusionCheckInterval", 1,
                                   type=int),
        fld_inner_boundary=cfg.get_lowercase(
            "RadiativeDiffusionInnerBoundary", "none"),
        fld_outer_boundary=cfg.get_lowercase(
            "RadiativeDiffusionOuterBoundary", "none"),
        fld_constant_fluxlimiter=cfg.get_flag(
            "RadiativeDiffusionTest1D", False),
        self_gravity=self_gravity,
        indirect_term_disk_on_disk=indirect_disk_on_disk,
        correct_disk_selfgravity=cfg.get_flag(
            "CorrectDiskSelfgravity", not self_gravity),
        self_gravity_mode=cfg.get_lowercase("SelfGravityMode", "besselkernel"),
        sg_kernel_update_interval=cfg.get(
            "SelfGravityStepsBetweenKernelUpdate", 20, type=int),
        sg_kernel_aspectratio_threshold=cfg.get(
            "SelfGravityAspectRatioChangeThreshold", 0.001, type=float),
        thickness_smoothing=cfg.get("ThicknessSmoothing", 0.6, type=float),
        thickness_smoothing_sg=cfg.get("ThicknessSmoothingSG",
                                       cfg.get("ThicknessSmoothing", 0.6, type=float),
                                       type=float),
        compatibility_smoothing_planetloc=cfg.get_flag("CompatibilitySmoothingPlanetLoc", False),
        compatibility_no_star_smoothing=cfg.get_flag("CompatibilityNoStarSmoothing", False),
        body_force_from_potential=cfg.get_flag("BodyForceFromPotential", True),
        fast_transport=transport_fast,
        flux_limiter_type=flux_limiter_type,
        hydro_integrator=hydro_integrator,
        cfl=cfg.get("CFL", 0.5, type=float),
        cfl_max_var=cfg.get("CFLmaxVar", 1.1, type=float),
        heating_cooling_cfl_limit=cfg.get("HeatingCoolingCFLlimit", 10.0, type=float),
        omega_frame=cfg.get("OmegaFrame", 0.0, type=float),
        corotating=corotating,
        corotation_reference_body=cfg.get("CorotationReferenceBody", 1, type=int),
        disk_feedback=cfg.get_flag("DiskFeedback", True),
        nbody_integrator=cfg.get_lowercase("NbodyIntegrator", "ias15"),
        shock_tube=cfg.get("ShockTube", 0, type=int),
        spreading_ring=cfg.get_flag("SpreadingRing", False),
        initialize_pure_keplerian=cfg.get_flag("InitializePureKeplerian", False),
        initialize_vradial_zero=cfg.get_flag("InitializeVradialZero", False),
        imposed_disk_drift=cfg.get("ImposedDiskDrift", 0.0, type=float),
        profile_cutoff_outer=cfg.get_flag("ProfileCutoffOuter", False),
        profile_cutoff_point_outer=cfg.get("ProfileCutoffPointOuter", 1e300, dim=u.DIM_LENGTH, type=float),
        profile_cutoff_width_outer=cfg.get("ProfileCutoffWidthOuter", 1.0, dim=u.DIM_LENGTH, type=float),
        profile_cutoff_inner=cfg.get_flag("ProfileCutoffInner", False),
        profile_cutoff_point_inner=cfg.get("ProfileCutoffPointInner", 0.0, dim=u.DIM_LENGTH, type=float),
        profile_cutoff_width_inner=cfg.get("ProfileCutoffWidthInner", 1.0, dim=u.DIM_LENGTH, type=float),
        center_mass_density_correction_factor=cfg.get("CenterProfileDensityCorrectionFactor", 1.0, type=float),
        viscous_outflow_speed=cfg.get("ViscousOutflowSpeed", 1.0, type=float),
        rochelobe_overflow=cfg.get_flag("RocheLobeOverflow", False),
        rof_planet=cfg.get("ROFplanet", 1, type=int),
        rof_temperature=cfg.get("ROFtemperature", 1000.0 / un.Temp0,
                                dim=u.DIM_TEMPERATURE, type=float),
        rof_mdot=cfg.get("ROFvalue", 1e-8, dim=u.DIM_MDOT, type=float),
        rof_rampingtime=cfg.get("ROFrampingtime", 30.0, type=float),
        rof_gamma=cfg.get("ROFgamma", 0.5, type=float),
        rof_variable_transfer=cfg.get_flag("ROFVariableTransfer", False),
        rof_averaging_time=cfg.get("ROFaveragingtime", 10.0, type=float),
        write_ecc_changes=cfg.get_flag("WriteEccentricityChange", False),
        damping=cfg.get_flag("Damping", False),
        damping_inner_limit=cfg.get("DampingInnerLimit", 1.05, type=float),
        damping_outer_limit=cfg.get("DampingOuterLimit", 0.95, type=float),
        damping_time_factor=cfg.get("DampingTimeFactor", 1.0, type=float),
        damping_time_radius_outer=cfg.get(
            "DampingTimeRadiusOuter", 0.0, dim=u.DIM_LENGTH, type=float),
        damping_energy_inner=cfg.get_lowercase("DampingEnergyInner", "none"),
        damping_vradial_inner=cfg.get_lowercase("DampingVRadialInner", "none"),
        damping_vazimuthal_inner=cfg.get_lowercase("DampingVAzimuthalInner", "none"),
        damping_surface_density_inner=cfg.get_lowercase("DampingSurfaceDensityInner", "none"),
        damping_energy_outer=cfg.get_lowercase("DampingEnergyOuter", "none"),
        damping_vradial_outer=cfg.get_lowercase("DampingVRadialOuter", "none"),
        damping_vazimuthal_outer=cfg.get_lowercase("DampingVAzimuthalOuter", "none"),
        damping_surface_density_outer=cfg.get_lowercase("DampingSurfaceDensityOuter", "none"),
        accretion_radius_fraction=cfg.get("MassAccretionRadius", 1.0, type=float),
        indirect_term_mode=cfg.get("IndirectTermMode", 0, type=int),
        calculate_disk=cfg.get_flag("Disk", True),
        integrate_particles=cfg.get_flag("IntegrateParticles", False),
        keep_mass_constant=cfg.get_flag("KeepDiskMassConstant", False),
        vaz_quadrupole_support=cfg.get_flag(
            "VazimuthalConsidersQuadropoleMoment", False),
        sigma_condition=_parse_condition(cfg, "SigmaCondition"),
        sigma_filename=cfg.get("SigmaFilename", "", type=str),
        energy_condition=_parse_condition(cfg, "EnergyCondition"),
        energy_filename=cfg.get("EnergyFilename", "", type=str),
        sigma_randomize=cfg.get_flag("RandomSigma", False),
        sigma_random_factor=cfg.get("RandomFactor", 0.1, type=float),
        sigma_feature_size=cfg.get(
            "FeatureSize",
            (cfg.get("Rmax", 10.0, type=float)
             - cfg.get("Rmin", 1.0, type=float)) / 150.0,
            dim=u.DIM_LENGTH, type=float),
        random_seed=cfg.get("RandomSeed", 0, type=int),
        cbd_ring=cfg.get_flag("CircumBinaryRing", False),
        cbd_ring_position=cfg.get("CircumBinaryRingPosition", 4.5,
                                  dim=u.DIM_LENGTH, type=float),
        cbd_ring_width=cfg.get("CircumBinaryRingWidth", 0.6,
                               dim=u.DIM_LENGTH, type=float),
        cbd_decay_width=cfg.get(
            "CircumBinaryDecayWidth",
            1.4 * cfg.get("CircumBinaryRingWidth", 0.6, dim=u.DIM_LENGTH,
                          type=float),
            dim=u.DIM_LENGTH, type=float),
        cbd_decay_exponent=cfg.get("CircumBinaryDecayExponent", 0.75,
                                   type=float),
        cbd_ring_enhancement_factor=cfg.get(
            "CircumBinaryRingEnhancementFactor", 2.5, type=float),
        secondary_disk=cfg.get_flag("SecondaryDisk", False),
        centrifugal_balance=cfg.get_flag("CentrifugalBalance", False),
        write_massflow=cfg.get_flag("WriteMassFlow", False),
        write_gas_torques=cfg.get_flag("WriteGasTorques", False),
        write_alpha_grav_mean=cfg.get_flag("WriteAlphaGravMean", False),
        write_alpha_reynolds_mean=cfg.get_flag("WriteAlphaReynoldsMean",
                                               False),
        quantities_radius_limit=cfg.get("QuantitiesRadiusLimit", 0.0,
                                        dim=u.DIM_LENGTH, type=float),
        disk_radius_mass_fraction=cfg.get("DiskRadiusMassFraction", 0.99,
                                          type=float),
        accrete_without_disk_feedback=cfg.get_flag(
            "AccreteWithoutDiskFeedback", False),
        bitwise_exact_restarting=cfg.get_flag("BitwiseExactRestarting",
                                              False),
        do_write_1d=cfg.get_flag("DoWrite1DFiles", True),
        write_density=cfg.get_flag("WriteDensity", True),
        write_velocity=cfg.get_flag("WriteVelocity", True),
        write_energy=cfg.get_flag("WriteEnergy", True),
        write_qplus=cfg.get_flag("WriteQPlus", False),
        write_qminus=cfg.get_flag("WriteQMinus", False),
        write_tau=cfg.get_flag("WriteTau", False),
        write_sg_accel_rad=cfg.get_flag("WriteSGAccelRad", False),
        write_sg_accel_azi=cfg.get_flag("WriteSGAccelAzi", False),
        write_radial_luminosity=cfg.get_flag("WriteRadialLuminosity",
                                             False),
        write_radial_dissipation=cfg.get_flag("WriteRadialDissipation",
                                              False),
        write_disk_quantities=cfg.get_flag("WriteDiskQuantities", True),
        distributed_output=cfg.get_flag("DistributedOutput", False),
        write_default_values=cfg.get_flag("WriteDefaultValues", False),
        planet_orbit_disk_test=cfg.get_flag("PlanetOrbitDiskTest", False),
        visc_accret_massflow_test=cfg.get_flag("ViscAccretMassflowTest",
                                               False),
        cic_planet=cfg.get_flag("CICPLANET", False),
        keplerian_azimuthal_inner_factor=cfg.get(
            "InnerBoundaryVaziKeplerianFactor", 1.0, type=float),
        keplerian_azimuthal_outer_factor=cfg.get(
            "OuterBoundaryVaziKeplerianFactor", 1.0, type=float),
        keplerian_radial_inner_factor=cfg.get(
            "InnerBoundaryVradKeplerianFactor", 0.1, type=float),
        keplerian_radial_outer_factor=cfg.get(
            "OuterBoundaryVradKeplerianFactor", 0.1, type=float),
        log_after_steps=cfg.get("LogAfterSteps", 0, type=int),
        log_after_real_seconds=cfg.get("LogAfterRealSeconds", 600.0,
                                       type=float),
        write_torques=cfg.get_flag("WriteTorques", False),
        write_lightcurves=cfg.get_flag("WriteLightCurves", False),
        lightcurves_radii=_parse_lightcurve_radii(cfg),
        snapshot_fields=_parse_snapshot_fields(cfg),
        dtype=dtype,
        **bcs,
    )


def _parse_condition(cfg: Config, key: str) -> str:
    """First-letter dispatch of Sigma/EnergyCondition
    (reference src/parameters.cpp:606-650)."""
    s = cfg.get_lowercase(key, "profile")
    first = s[0] if s else "p"
    return {"p": "profile", "n": "nbody", "1": "1d", "2": "2d"}.get(
        first, "profile")


def _parse_lightcurve_radii(cfg: Config) -> tuple:
    """reference src/parameters.cpp:352-380: user radii inside (Rmin, Rmax),
    plus the domain edges, sorted."""
    if "WriteLightCurvesRadii" not in cfg:
        return ()
    raw = str(cfg.get_raw("WriteLightCurvesRadii"))
    rmin = cfg.get("Rmin", 1.0, type=float)
    rmax = cfg.get("Rmax", 10.0, type=float)
    vals = []
    for tok in raw.replace(",", " ").split():
        try:
            v = float(tok)
        except ValueError:
            continue
        if rmin < v < rmax:
            vals.append(v)
    vals += [rmin, rmax]
    return tuple(sorted(vals))


# Write* flag -> extra 2-D snapshot fields (reference
# src/parameters.cpp:243-312 t_data set_write calls)
_SNAPSHOT_FIELD_FLAGS = (
    ("WriteTemperature", ("Temperature",)),
    ("WriteSoundSpeed", ("SoundSpeed",)),
    ("WritePressure", ("Pressure",)),
    ("WriteToomre", ("Toomre",)),
    ("WriteEccentricity", ("EccentricityX", "EccentricityY")),
    ("WritePotential", ("Potential",)),
    ("WriteKappa", ("Kappa",)),
    ("WriteTauCool", ("TauCool",)),
    ("WriteAlphaGrav", ("AlphaGrav",)),
    ("WriteAlphaReynolds", ("AlphaReynolds",)),
    ("WriteAspectratio", ("AspectRatio",)),
    # tau_eff / visiblity match the reference grid names verbatim
    # (src/data.cpp:250-263; 'visiblity' is the reference's own spelling
    # and the grid is registered but never filled -> zeros)
    ("WriteVerticalOpticalDepth", ("tau_eff",)),
    ("WriteVisibility", ("visiblity",)),
    ("WriteViscosity", ("Viscosity",)),
    ("WriteDivV", ("DivV",)),
    ("WriteTReynolds", ("TReynolds",)),
    ("WriteTGravitational", ("TGravitational",)),
    ("WriteEffectiveGamma", ("GammaEff",)),
    ("WriteFirstAdiabaticIndex", ("Gamma1",)),
    ("WriteMeanMolecularWeight", ("Mu",)),
    ("WriteAlpha", ("Alpha",)),
    ("WriteScaleHeight", ("ScaleHeight",)),
    ("WritepDV", ("PdivV",)),
    ("WriteTau", ("Tau",)),
    ("WriteSGAccelRad", ("SGAccelRad",)),
    ("WriteSGAccelAzi", ("SGAccelAzi",)),
)


def _parse_snapshot_fields(cfg: Config) -> tuple:
    out = []
    for flag, names in _SNAPSHOT_FIELD_FLAGS:
        if cfg.get_flag(flag, False):
            out.extend(names)
    return tuple(out)

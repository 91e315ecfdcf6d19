"""What this copy covers: the physics of the benchmark's planet-disk
configurations (``port_bench/configs/``), the power-law disk around a star
and its planets in a fixed frame rotating at OmegaFrame, with the ideal
or locally isothermal equation of state, viscous heating, constant beta
and surface cooling, stellar irradiation, SN and TW artificial
viscosity, damping zones toward the initial state, named
boundaries, FARGO transport on the Euler integrator, the bodies on IAS15
(their potential with cubic and thickness smoothing, the disk's pull on
them, the predictor's indirect term) and the dust on the midpoint or
exponential-midpoint integrator. The port's other branches were left out
of the copy; a setup that asks for one is refused here, so that the
reference never takes a branch it lacks."""

from __future__ import annotations

from .params import ARTVISC_SN, ARTVISC_TW, LEAPFROG, Physics


def refuse_outside(phys: Physics, bodies, cfg, transport_route) -> None:
    """Raise ValueError naming what the setup asks for outside the copy."""
    asked = {
        "ShockTube": phys.shock_tube != 0,
        "PVTE": phys.variable_gamma,
        "FLD": phys.radiative_diffusion,
        "self-gravity": phys.self_gravity,
        "the spreading ring": phys.spreading_ring,
        "Sigma/EnergyCondition other than profile":
            phys.sigma_condition != "profile"
            or phys.energy_condition != "profile",
        "RandomSigma": phys.sigma_randomize,
        "SetSigma0": phys.sigma_adjust,
        "the circumbinary ring": phys.cbd_ring,
        "the secondary's disk": phys.secondary_disk,
        "CentrifugalBalance": phys.centrifugal_balance,
        "the leapfrog": phys.hydro_integrator == LEAPFROG,
        "damping toward a target other than the initial state": phys.damping
            and any(m not in ("initial", "reference", "none") for m in (
                phys.damping_surface_density_inner,
                phys.damping_surface_density_outer,
                phys.damping_energy_inner, phys.damping_energy_outer,
                phys.damping_vazimuthal_inner,
                phys.damping_vazimuthal_outer,
                phys.damping_vradial_inner, phys.damping_vradial_outer)),
        "an N-body integrator other than IAS15":
            phys.nbody_integrator != "ias15",
        "the Euler-sum indirect term (IndirectTermMode 1)":
            phys.indirect_term_mode != 0,
        "the binary quadrupole support": phys.vaz_quadrupole_support,
        "accretion onto bodies": any(b.accretion_type != "none"
                                     for b in bodies),
        "a corotating frame": phys.corotating,
        "CICPLANET": phys.cic_planet,
        "KlahrSmoothingRadius": "KlahrSmoothingRadius" in cfg,
        "Roche-lobe overflow": phys.rochelobe_overflow,
        "the centerofmass or custom boundary": bool(
            {phys.composite_inner, phys.composite_outer}
            & {"centerofmass", "custom"}),
        "CustomBoundaryModule": "CustomBoundaryModule" in cfg,
        "S-curve cooling": phys.cooling_scurve_enabled,
        "Ziampras's beta": phys.cooling_beta_method != "no",
        "artificial viscosity other than SN and TW":
            phys.artificial_viscosity not in (ARTVISC_SN, ARTVISC_TW, "none"),
        "AlphaMode": phys.alpha_mode != 0,
        "StabilizeViscosity": phys.stabilize_viscosity != 0,
        "AspectRatioMode": phys.aspectratio_mode != 0,
        "a transport route": transport_route is not None,
        "Disk: no": not phys.calculate_disk,
        "KeepDiskMassConstant": phys.keep_mass_constant,
        "WriteEccentricityChange": phys.write_ecc_changes,
        "the monitor grids": phys.write_massflow or phys.write_gas_torques
            or phys.write_alpha_grav_mean or phys.write_alpha_reynolds_mean,
    }
    found = [k for k, v in asked.items() if v]
    if found:
        raise ValueError("the benchmark's reference does not cover: "
                         + ", ".join(found))

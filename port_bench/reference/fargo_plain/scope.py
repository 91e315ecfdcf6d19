"""What this copy covers: the physics of the benchmark's configurations
(``port_bench/configs/``), the power-law disk around one star with the
ideal or PVTE equation of state, viscous heating, constant beta and
surface cooling, FLD, the FFT self-gravity, SN artificial viscosity,
named boundaries, FARGO transport on the Euler integrator and the dust
on the midpoint or exponential-midpoint integrator. The port's other
branches were left out of the copy; a setup that asks for one is
refused here, so that the reference never takes a branch it lacks."""

from __future__ import annotations

from .params import ARTVISC_SN, LEAPFROG, Physics


def refuse_outside(phys: Physics, bodies, cfg, transport_route) -> None:
    """Raise ValueError naming what the setup asks for outside the copy."""
    asked = {
        "ShockTube": phys.shock_tube != 0,
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
        "damping zones": phys.damping,
        "more than one body": len(bodies) > 1,
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
        "stellar irradiation": phys.heating_star
            or any(b.irradiate for b in bodies),
        "the PVTE lookup table": phys.pvte_lookup_table,
        "artificial viscosity other than SN":
            phys.artificial_viscosity not in (ARTVISC_SN, "none"),
        "the Bessel-kernel self-gravity": phys.self_gravity
            and phys.self_gravity_mode == "besselkernel",
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

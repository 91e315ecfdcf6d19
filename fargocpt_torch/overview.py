"""Overview dashboard: multi-panel figure of a simulation output directory
(replaces the reference python_module/fargocpt/overview.py live plot).

Usage:
    python -m fargocpt_tpu.overview OUTDIR [-N SNAPSHOT] [-o overview.png]

Panels: Sigma map (polar -> cartesian), azimuthal Sigma/Temperature
profiles, disk mass & eccentricity history, planet semi-major axes, and
the timestep history.
"""

from __future__ import annotations

import argparse

import numpy as np

from .analysis import Loader


def make_overview(outdir, snapshot="last", out_png="overview.png"):
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    l = Loader(outdir)
    sid = l.resolve_snapshot(snapshot)

    fig, axes = plt.subplots(2, 3, figsize=(15, 9))
    fig.suptitle(f"{outdir} — snapshot {sid}")

    # Sigma map
    ax = axes[0, 0]
    R, PHI, sigma = l.gas.get("Sigma", sid)
    # close the azimuthal seam
    R = np.concatenate([R, R[:, :1]], axis=1)
    PHI = np.concatenate([PHI, PHI[:, :1] + 2 * np.pi], axis=1)
    sigma = np.concatenate([sigma, sigma[:, :1]], axis=1)
    x = R * np.cos(PHI)
    y = R * np.sin(PHI)
    pc = ax.pcolormesh(x, y, np.log10(np.maximum(sigma, 1e-300)),
                       shading="gouraud", cmap="magma")
    fig.colorbar(pc, ax=ax, label=r"$\log_{10}\Sigma$ [code]")
    ax.set_aspect("equal")
    ax.set_title("surface density")

    # radial profiles
    ax = axes[0, 1]
    r1, avg = l.gas.avg("Sigma", sid)
    ax.loglog(r1, avg, label=r"$\Sigma$")
    try:
        rt, tavg = l.gas.avg("Temperature", sid)
        ax2 = ax.twinx()
        ax2.loglog(rt, tavg, color="C1", label="T")
        ax2.set_ylabel("T [code]", color="C1")
    except FileNotFoundError:
        pass
    ax.set_xlabel("r")
    ax.set_ylabel(r"$\Sigma$ [code]")
    ax.set_title("radial profiles")

    # vrad profile
    ax = axes[0, 2]
    rv, vavg = l.gas.avg("vrad", sid)
    ax.semilogx(rv, vavg)
    ax.axhline(0, color="k", lw=0.5)
    ax.set_xlabel("r")
    ax.set_title(r"$\langle v_r\rangle$")

    # disk mass + eccentricity history
    ax = axes[1, 0]
    t, mass = l.quantities("time", "mass")
    ax.plot(t, mass / mass[0] if mass[0] else mass)
    ax.set_xlabel("t [code]")
    ax.set_title("disk mass / initial")
    try:
        t2, ecc = l.quantities("time", "eccentricity")
        ax2 = ax.twinx()
        ax2.plot(t2, ecc, color="C2")
        ax2.set_ylabel("disk ecc", color="C2")
    except Exception:
        pass

    # planet orbits
    ax = axes[1, 1]
    k = 1
    plotted = False
    while True:
        try:
            orbit = l.nbody(k)
        except FileNotFoundError:
            break
        ax.plot(orbit["time"], orbit["semi-major axis"], label=f"body {k}")
        plotted = True
        k += 1
    if plotted:
        ax.legend()
    ax.set_xlabel("t [code]")
    ax.set_title("semi-major axes")

    # timestep history
    ax = axes[1, 2]
    try:
        log = l.timestep_log()
        ax.semilogy(log["time"], log["mean dt"])
        ax.set_xlabel("t [code]")
        ax.set_title("mean hydro dt per monitor")
    except FileNotFoundError:
        ax.axis("off")

    fig.tight_layout()
    fig.savefig(out_png, dpi=110)
    plt.close(fig)
    return out_png


def follow(outdir, out_png="overview.png", interval: float = 2.0,
           max_updates: int | None = None, timeout: float | None = None):
    """Live monitor of a running simulation (the reference's
    python_module/fargocpt/overview.py:350 ``Overview.show(follow=...)``
    polls snapshots/list.txt the same way): regenerate the overview every
    time a new snapshot is registered.  Headless-friendly — the refreshed
    PNG is the live view; point an image viewer at it.  Returns the
    number of refreshes done (``max_updates`` / ``timeout`` bound the
    loop).  Must run on the main thread (matplotlib is not thread-safe;
    rendering from a worker thread can deadlock)."""
    import time
    from pathlib import Path

    list_txt = Path(outdir) / "snapshots" / "list.txt"
    last_seen = None
    n_updates = 0
    t0 = time.monotonic()
    while True:
        try:
            lines = [ln for ln in list_txt.read_text().splitlines() if ln]
        except FileNotFoundError:
            lines = []
        newest = lines[-1] if lines else None
        if newest is not None and newest != last_seen:
            make_overview(outdir, newest, out_png)
            print(f"overview: snapshot {newest} -> {out_png}", flush=True)
            last_seen = newest
            n_updates += 1
        if max_updates is not None and n_updates >= max_updates:
            return n_updates
        if timeout is not None and time.monotonic() - t0 > timeout:
            return n_updates
        time.sleep(interval)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("outdir")
    ap.add_argument("-N", "--snapshot", default="last")
    ap.add_argument("-o", "--out", default="overview.png")
    ap.add_argument("--follow", type=float, default=None, metavar="SECONDS",
                    help="live mode: poll for new snapshots every SECONDS "
                         "and refresh the PNG (reference Overview.show)")
    args = ap.parse_args(argv)
    if args.follow is not None:
        follow(args.outdir, args.out, interval=args.follow)
        return
    path = make_overview(args.outdir, args.snapshot, args.out)
    print(f"wrote {path}")


if __name__ == "__main__":
    main()

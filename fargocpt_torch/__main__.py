"""Command-line interface.

Mirrors the reference launcher semantics
(python_module/fargocpt/_command_line_.py + src/options.cpp) and the JAX
package's ``python -m fargocpt_tpu``:

  python -m fargocpt_torch start setup.yml [-o OUT] [--device cpu]
  python -m fargocpt_torch restart <N|last> setup.yml
  python -m fargocpt_torch auto setup.yml
  python -m fargocpt_torch data OUTDIR [path [N]]
  python -m fargocpt_torch config show|get KEY|set KEY VALUE|remove KEY

One process drives one device: the card (``--device cuda``, the default,
through the CUDA kernels) or the CPU (``--device cpu``, through their
plain PyTorch versions). ``data`` and ``config`` dispatch before
``torch`` is imported. ``--debug-nans`` checks the state after every
hydro step and stops at the first NaN or infinity with a
``FloatingPointError`` naming the field and the step. ``bench`` is not
ported yet and raises ``NotImplementedError``.
"""

from __future__ import annotations

import argparse
import signal
import sys


def _add_log_flags(p):
    """Reference log-level options (src/options.cpp:46-69,:130-136)."""
    p.add_argument("-q", "--quiet", action="store_true",
                   help="only print errors and warnings")
    p.add_argument("-v", "--verbose", action="store_true",
                   help="verbose mode")
    p.add_argument("-d", "--debug", action="store_true",
                   help="print debug information at each monitor step")


def _add_run_flags(p):
    p.add_argument("-o", "--outdir", default=None)
    p.add_argument("--dtype", default=None, choices=["float64", "float32"])
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="run on the card (default) or on the CPU")
    p.add_argument("-N", "--max-iterations", type=int, default=None)
    p.add_argument("--profile", metavar="DIR", default=None,
                   help="write a torch.profiler trace of the run to "
                        "DIR/trace.json; it holds the port's fc: spans "
                        "(each monitor interval an fc:sim.advance_monitor "
                        "with its phases nested inside) beside the card's "
                        "kernels")
    p.add_argument("--debug-nans", action="store_true",
                   help="stop at the first NaN or infinity in the state, "
                        "checked after every hydro step")
    _add_log_flags(p)


def main(argv=None):
    # info subcommands dispatch before the torch-heavy launcher path
    # (reference python_module/fargocpt/_command_line_.py:30-39)
    argv_eff = sys.argv[1:] if argv is None else argv
    if argv_eff and argv_eff[0] == "data":
        from .analysis import data_main
        return data_main(argv_eff[1:])
    if argv_eff and argv_eff[0] == "config":
        from .usercfg import main as config_main
        return config_main(argv_eff[1:])

    parser = argparse.ArgumentParser(prog="fargocpt_torch")
    sub = parser.add_subparsers(dest="mode", required=True)
    sub.add_parser("data", help="inspect an output directory "
                   "(fargocpt_torch data OUTDIR [path [N]])")
    sub.add_parser("config", help="user tool preferences "
                   "(show/get/set/remove)")
    for mode in ("start", "auto"):
        p = sub.add_parser(mode)
        p.add_argument("setup", help="YAML setup file")
        _add_run_flags(p)
    p = sub.add_parser("restart")
    p.add_argument("snapshot", help="snapshot number (or 'last')")
    p.add_argument("setup", help="YAML setup file")
    _add_run_flags(p)
    p = sub.add_parser("bench", help="the headline benchmark (not ported "
                       "yet)")
    p.add_argument("--nrad", type=int, default=1024)
    p.add_argument("--naz", type=int, default=3072)
    p.add_argument("--steps", type=int, default=100)

    args = parser.parse_args(argv_eff)
    if args.mode == "bench":
        raise NotImplementedError(
            "bench (the port's benchmark entry) is not ported yet")
    if args.dtype is None:
        # launcher defaults from the user config store
        # (``fargocpt_torch config set default_dtype float32``)
        from .usercfg import UserConfig
        args.dtype = UserConfig().get("default_dtype", "float64")
    if args.outdir is None:
        from .usercfg import UserConfig
        base = UserConfig().get("default_outdir")
        if base:
            import os
            import pathlib
            args.outdir = os.path.join(base, pathlib.Path(args.setup).stem)
    return _launch(args)


class _Tee:
    def __init__(self, *streams):
        self.streams = streams

    def write(self, s):
        for st in self.streams:
            st.write(s)

    def flush(self):
        for st in self.streams:
            st.flush()


def _launch(args) -> int:
    """start / auto / restart. Whatever it changes in the process (signal
    handlers, sys.stdout, the log files) is put back on return, so the
    CLI can run in-process more than once."""
    import faulthandler
    import os
    import shutil
    import time
    from pathlib import Path

    from . import log
    saved_handlers = {sig: signal.getsignal(sig)
                      for sig in (signal.SIGTERM, signal.SIGUSR1)}
    saved_stdout, saved_level = sys.stdout, log.print_level
    # benign placeholder so a SIGUSR1 arriving during the (slow) torch
    # import and the first kernel build doesn't kill the process before
    # the real handler is registered below; SIGUSR2 prints every thread's
    # stack (reference src/backtrace.cpp)
    signal.signal(signal.SIGUSR1, lambda *_: None)
    faulthandler.register(signal.SIGUSR2, file=sys.__stderr__,
                          all_threads=True)
    writer = log_fh = None
    try:
        from . import build_info, output as out
        from .config import Config
        from .sim import Simulation

        # leveled logging (reference src/logging.cpp print_level semantics)
        if args.quiet:
            log.set_print_level(log.WARNING)
        elif args.debug:
            log.set_print_level(log.DEBUG)
        elif args.verbose:
            log.set_print_level(log.VERBOSE)
        log.notice(build_info())

        cfg = Config.from_file(args.setup)
        sim = Simulation(cfg, outdir=args.outdir, dtype=args.dtype,
                         device=args.device)
        sim.stepper.debug_nans = args.debug_nans
        writer = out.OutputWriter(sim)
        log.notice(f"device {sim.device}, {args.dtype}; snapshot writer: "
                   + ("native (background thread)" if writer.is_native
                      else "numpy (synchronous)"))

        # pidfile for external supervision (reference
        # src/parallel.cpp:44-50)
        (writer.outdir / "fargocpt.pid").write_text(f"{os.getpid()}\n")
        # mirror the progress log into the output dir (reference
        # src/logging.cpp:43-60 per-run log files)
        (writer.outdir / "logs").mkdir(exist_ok=True)
        log_fh = open(writer.outdir / "logs" / "fargocpt.log", "a")
        # leveled per-run files log_0.txt/err_0.txt + pre-init buffer flush
        log.init_logfiles(writer.outdir)
        # -v: tell everything about the parameters file (reference
        # src/options.cpp:68 + the reference's verbose parameter echo)
        for key, val in sorted(cfg._consulted.items()):
            log.verbose(f"param {cfg._orig_case.get(key, key)} = {val!r}")
        sys.stdout = _Tee(saved_stdout, log_fh)

        profiler = None
        if args.profile:
            # a torch.profiler trace (viewable in chrome://tracing or
            # perfetto), with the fc: spans of ``telemetry``, which are on
            # while it records; the reference has no tracer
            from torch.profiler import ProfilerActivity, profile
            acts = [ProfilerActivity.CPU]
            if sim.device.type == "cuda":
                acts.append(ProfilerActivity.CUDA)
            profiler = profile(activities=acts)
            profiler.start()

        if args.mode == "restart":
            sid = args.snapshot
            if sid == "last":
                sid = out.last_snapshot_id(writer.outdir)
            out.restore_simulation(sim, writer.outdir, sid)
            log.notice(f"restarted from snapshot {sid} at t = "
                       f"{float(sim.time):.6g}")
        elif args.mode == "auto":
            list_file = writer.outdir / "snapshots" / "list.txt"
            if list_file.exists() and list_file.read_text().strip():
                sid = out.last_snapshot_id(writer.outdir)
                out.restore_simulation(sim, writer.outdir, sid)
                log.notice(f"auto: resuming from snapshot {sid} at t = "
                           f"{float(sim.time):.6g}")
            else:
                log.notice("auto: no snapshots found, starting fresh")

        # SIGTERM -> autosave + clean exit (reference
        # src/simulation.cpp:497-531)
        stop_requested = {"flag": False}

        def _sigterm(_signum, _frame):
            stop_requested["flag"] = True

        signal.signal(signal.SIGTERM, _sigterm)

        # SIGUSR1 -> CFL/timestep report (reference src/cfl.cpp:358-372
        # PRINT_SIG_INFO); the CFL is taken apart from any step in flight
        def _sigusr1(_signum, _frame):
            with sim.stepper.detached():
                cfl_dt = float(sim.stepper.cfl_dt(sim.state))
            log.notice(f"[SIGUSR1] t = {float(sim.time):.8g}  monitor "
                       f"{sim.n_monitor}  hydro steps {sim.n_hydro_iter}  "
                       f"last_dt = {float(sim.last_dt):.6g}  CFL dt = "
                       f"{cfl_dt:.6g}")

        signal.signal(signal.SIGUSR1, _sigusr1)

        # copy the setup file into the output dir for provenance
        shutil.copyfile(args.setup, writer.outdir / "parameters" / "setup.yml")

        s = sim.settings
        total_monitors = s.n_snapshots * s.n_monitor
        log_state = {"steps": 0, "wall": time.time()}
        sim.begin()
        while sim.n_monitor < total_monitors:
            # -N: at most that many hydro steps in all (reference
            # src/options.cpp), checked at every step
            left = None if args.max_iterations is None \
                else args.max_iterations - sim.n_hydro_iter
            if left is not None and left <= 0:
                break
            if stop_requested["flag"]:
                writer.write_snapshot("autosave", register=False)
                log.notice("SIGTERM received: autosave written, exiting")
                return 0
            if not sim.advance_monitor(left):
                log.notice(f"stopped after {sim.n_hydro_iter} hydro steps "
                           f"(-N) at t = {float(sim.time):.6g}")
                break
            # autosave dirs are cleaned after the next real snapshot
            # (reference src/output.cpp:225-248)
            autosave = writer.outdir / "snapshots" / "autosave"
            if autosave.exists() and sim.n_monitor % s.n_monitor == 0:
                shutil.rmtree(autosave, ignore_errors=True)
            stats = sim.monitor_stats
            rate = stats["n_steps"] / max(stats["walltime"], 1e-9)
            # runtime-log throttle (reference src/logging.cpp:214-235
            # LogAfterSteps / LogAfterRealSeconds): lines are logged at
            # monitor boundaries only, the keys set minimum gaps between
            log_now = True
            if sim.phys.log_after_steps > 0:
                log_now = (sim.n_hydro_iter - log_state["steps"]
                           >= sim.phys.log_after_steps)
            elif sim.phys.log_after_real_seconds > 0.0:
                log_now = (time.time() - log_state["wall"]
                           >= sim.phys.log_after_real_seconds)
            if log_now or sim.n_monitor == total_monitors:
                log_state["steps"] = sim.n_hydro_iter
                log_state["wall"] = time.time()
                log.info(f"monitor {sim.n_monitor}/{total_monitors}  "
                         f"t={float(sim.time):.6g}  "
                         f"steps={sim.n_hydro_iter}  {rate:.1f} steps/s")
                log.debug(f"  dt range [{stats['dt_min']:.4g}, "
                          f"{stats['dt_max']:.4g}]  walltime "
                          f"{stats['walltime']:.3f} s")
        if profiler is not None:
            profiler.stop()
            Path(args.profile).mkdir(parents=True, exist_ok=True)
            trace = Path(args.profile) / "trace.json"
            profiler.export_chrome_trace(str(trace))
            log.notice(f"profiler trace written to {trace}")
        log.notice("done")
        return 0
    finally:
        sys.stdout = saved_stdout
        for sig, handler in saved_handlers.items():
            signal.signal(sig, handler)
        faulthandler.unregister(signal.SIGUSR2)
        if writer is not None:
            writer.close()
        if log_fh is not None:
            log_fh.close()
        log.finalize()
        log.set_print_level(saved_level)


if __name__ == "__main__":
    sys.exit(main())

"""fargocpt_torch — the FargoCPT disk-hydrodynamics rebuild on PyTorch.

The same 2-D polar-grid physics as ``fargocpt_tpu`` (the JAX package kept
beside it as the reference), written for PyTorch tensors: plain tensor code
for everything that runs on the CPU, and hand-written CUDA kernels
(``csrc/``, built at first use) for the fused ops of the time step when
the tensors live on a GPU.

    python -m fargocpt_torch start setup.yml -o OUT [--device cpu]

runs a setup from the command line (``__main__``) and writes the JAX
package's output layout (``output``); ``auto`` and ``restart`` resume it.

Field conventions match the JAX package: sigma, energy and vaz are
(NR, NAZ) with rings 0 and NR-1 as ghosts; vrad is (NR+1, NAZ).

This package imports ``torch`` and never ``jax``.
"""

__version__ = "0.1.0"


def build_info() -> str:
    """Version + git commit/dirty stamp of the installed tree (reference
    src/buildtime_info.cpp prints the compile-time git state; here it is
    read live from the package's repository when available)."""
    import subprocess as _sp
    from pathlib import Path as _Path
    root = _Path(__file__).resolve().parent.parent
    commit, dirty = "unknown", ""
    try:
        commit = _sp.run(
            ["git", "-C", str(root), "rev-parse", "--short", "HEAD"],
            capture_output=True, text=True, timeout=5).stdout.strip() \
            or "unknown"
        changed = _sp.run(
            ["git", "-C", str(root), "diff-index", "--name-only", "HEAD"],
            capture_output=True, text=True, timeout=5).stdout.strip()
        if changed:
            dirty = f" (dirty: {len(changed.splitlines())} files)"
    except (OSError, _sp.SubprocessError):
        pass
    return f"fargocpt_torch {__version__} git {commit}{dirty}"


def run(args, np=None, nt=None, stdout=None, exe=None, detach=False):
    """Single-call launcher, API-compatible with the reference's
    ``fargocpt.run(fargo_args, np=..., nt=...)``
    (python_module/fargocpt/run.py:199). ``args`` is the CLI argv, e.g.
    ``["start", "setup.yml", "-o", "out", "--device", "cpu"]``. The
    MPI/OpenMP process allocation knobs (np/nt) are accepted for drop-in
    compatibility but unused: one process drives the card. Returns the CLI
    exit code."""
    del np, nt, exe, detach
    import contextlib

    from . import __main__ as cli
    if stdout is not None:
        with contextlib.redirect_stdout(stdout):
            return cli.main(list(args))
    return cli.main(list(args))


def Loader(outdir):
    """Reference-API convenience re-export (``fargocpt.Loader``,
    python_module/fargocpt/data.py)."""
    from .analysis import Loader as _Loader
    return _Loader(outdir)

"""Start n ranks of one program: ``torch.multiprocessing`` with ``spawn``
(the start method CUDA needs), one process per rank, each joined to a
``torch.distributed`` group of the backend the caller names.

    results = launch(fn, n, backend="gloo", device="cpu", args=(cfg,))

runs ``fn(comm, *args)`` on every rank with a ``Communicator`` and returns
the ranks' return values in rank order (they must pickle). Nothing is
chosen for the caller: the backend and the device are arguments, and a
pair that cannot work raises before a process starts. NCCL needs a card a
rank (it refuses two ranks on one device, "Duplicate GPU detected"), so
rank k takes ``cuda:k`` under NCCL; under gloo every rank takes the device
as named, so ranks may share one card (the communicator then stages each
collective through the host).

The ranks meet at ``init_method``: a ``file://`` path when the caller
gives one (tests under xdist give each test its own), else
``tcp://localhost:<port>`` on a port the parent finds free.
"""

from __future__ import annotations

import queue as _queue
import socket
import traceback

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from .comm import Communicator


def free_port() -> int:
    """A TCP port of localhost that is free now."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def rank_device(backend: str, device: str, rank: int) -> torch.device:
    """The device of ``rank``: ``cuda:rank`` under NCCL, else ``device``
    (a card named without an index is card 0)."""
    dev = torch.device(device)
    if backend == "nccl":
        return torch.device("cuda", rank)
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", 0)
    return dev


def check_pair(backend: str, device: str, n: int) -> None:
    """Raise by name where ``backend`` and ``device`` cannot carry n
    ranks."""
    dev = torch.device(device)
    if backend not in ("gloo", "nccl"):
        raise ValueError(f"backend {backend!r}: name gloo or nccl")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} requested but torch.cuda is "
                           "not available")
    if backend == "nccl":
        if dev.type != "cuda":
            raise ValueError(f"the nccl backend moves CUDA tensors only; "
                             f"device {device!r} cannot work with it")
        if n > torch.cuda.device_count():
            raise ValueError(
                f"nccl needs a card a rank: {n} ranks, "
                f"{torch.cuda.device_count()} cards (two ranks on one card "
                "fail with 'Duplicate GPU detected'); share a card with the "
                "gloo backend instead")


def _rank_main(rank, fn, n, backend, device, init_method, threads, args,
               queue):
    try:
        if threads is not None:
            torch.set_num_threads(threads)
        dev = rank_device(backend, device, rank)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        dist.init_process_group(backend, init_method=init_method,
                                world_size=n, rank=rank)
        try:
            out = fn(Communicator(dev), *args)
        finally:
            dist.destroy_process_group()
        queue.put((rank, True, out))
    except BaseException:
        queue.put((rank, False, traceback.format_exc()))
        raise


def launch(fn, n: int, *, backend: str, device: str, args: tuple = (),
           init_method: str | None = None, threads: int | None = None):
    """Run ``fn(comm, *args)`` on n spawned ranks; return their results in
    rank order, or raise RuntimeError with the first failing rank's
    traceback."""
    check_pair(backend, device, n)
    if init_method is None:
        init_method = f"tcp://localhost:{free_port()}"
    ctx = mp.get_context("spawn")
    queue = ctx.Queue()
    procs = [ctx.Process(target=_rank_main,
                         args=(k, fn, n, backend, device, init_method,
                               threads, args, queue), daemon=False)
             for k in range(n)]
    for p in procs:
        p.start()
    results, errors = {}, []
    try:
        while len(results) < n and not errors:
            try:
                rank, ok, out = queue.get(timeout=1.0)
            except _queue.Empty:
                # a rank that died without a word (a signal) ends the wait
                dead = [k for k, p in enumerate(procs)
                        if p.exitcode not in (None, 0) and k not in results]
                if dead:
                    errors.append((dead[0], f"exit code "
                                   f"{procs[dead[0]].exitcode}"))
                continue
            if ok:
                results[rank] = out
            else:
                errors.append((rank, out))
    finally:
        if errors:
            for p in procs:
                if p.is_alive():
                    p.terminate()
        for p in procs:
            p.join()
    if errors:
        rank, tb = errors[0]
        raise RuntimeError(f"rank {rank} of {n} failed:\n{tb}")
    bad = [k for k, p in enumerate(procs) if p.exitcode != 0]
    if bad:
        raise RuntimeError(f"ranks {bad} of {n} exited with codes "
                           f"{[procs[k].exitcode for k in bad]}")
    return [results[k] for k in range(n)]


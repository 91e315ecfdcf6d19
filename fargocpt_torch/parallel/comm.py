"""The ranks' communicator: the counterpart of the JAX package's mesh axis
``AXIS`` and of the ``lax`` collectives it names
(fargocpt_tpu/parallel/shard_step.py), over one ``torch.distributed``
process group with one process per rank:

* ``lax.ppermute`` up and down the radial slabs -> ``exchange``, one
  ``batch_isend_irecv`` of the stacked blocks each way;
* ``lax.psum`` / ``lax.pmin`` -> ``sum`` / ``min`` (``all_reduce``);
* ``lax.all_gather(..., tiled=True)`` along the rows -> ``gather_rows``.

The backend is the process group's, named by whoever made the group, and
the tensors' device is named here; neither is chosen for the caller. gloo
moves CPU tensors only (on CUDA tensors it offers broadcast and all_reduce
alone), so with gloo and a CUDA device every collective goes through host
copies: the tensor is copied to the host, the host copy travels, the
result is copied back. That staging is the design of the gloo/CUDA pair,
not a fallback, and it is the pair that lets several ranks share one card.
NCCL moves device tensors and needs a card a rank; a CPU device under
NCCL raises.

``bytes_sent`` counts, per kind of collective, the bytes this rank put on
the wire: an exchange its blocks to the neighbours that exist, an
all_gather (ring) its rows to the n - 1 others, an all_reduce its tensor,
a broadcast its tensor on the source rank.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

KINDS = ("exchange", "all_gather", "all_reduce", "broadcast")


class Communicator:
    """Collectives of one rank over ``group`` (the default group when
    None), on tensors of ``device``."""

    def __init__(self, device: torch.device | str, group=None):
        if not dist.is_initialized():
            raise RuntimeError("torch.distributed is not initialised: call "
                               "init_process_group with a backend first")
        self.group = group
        self.device = torch.device(device)
        if self.device.type == "cuda" and self.device.index is None:
            # the tensors' own name for the card ("cuda:k")
            self.device = torch.device("cuda", torch.cuda.current_device())
        self.backend = str(dist.get_backend(group)).lower()
        self.rank = dist.get_rank(group)
        self.size = dist.get_world_size(group)
        if self.backend == "gloo":
            self.staged = self.device.type == "cuda"
        elif self.backend == "nccl":
            if self.device.type != "cuda":
                raise ValueError(f"the nccl backend moves CUDA tensors only; "
                                 f"device {self.device} cannot work with it")
            self.staged = False
        else:
            raise ValueError(f"backend {self.backend!r} is not supported: "
                             "name gloo or nccl")
        self.bytes_sent = dict.fromkeys(KINDS, 0)

    def reset_counters(self) -> None:
        self.bytes_sent = dict.fromkeys(KINDS, 0)

    # ------------------------------------------------------------------
    def _wire(self, t: torch.Tensor) -> torch.Tensor:
        """The tensor the backend moves: a host copy under gloo with a
        CUDA device, the tensor itself otherwise (contiguous)."""
        t = t.contiguous()
        return t.to("cpu") if self.staged else t

    def _back(self, t: torch.Tensor) -> torch.Tensor:
        return t.to(self.device) if self.staged else t

    # ------------------------------------------------------------------
    def exchange(self, up: torch.Tensor, down: torch.Tensor):
        """Send ``up`` to the rank above and ``down`` to the rank below;
        return (from_below, from_above), the blocks the neighbours sent.
        An edge rank receives zeros where it has no neighbour, as
        ``lax.ppermute`` gives them."""
        r, n = self.rank, self.size
        up_w, down_w = self._wire(up), self._wire(down)
        from_below = torch.zeros_like(up_w)
        from_above = torch.zeros_like(down_w)
        ops = []
        if r + 1 < n:
            ops.append(dist.P2POp(dist.isend, up_w, self._peer(r + 1),
                                  self.group))
            ops.append(dist.P2POp(dist.irecv, from_above, self._peer(r + 1),
                                  self.group))
            self.bytes_sent["exchange"] += up_w.numel() * up_w.element_size()
        if r > 0:
            ops.append(dist.P2POp(dist.isend, down_w, self._peer(r - 1),
                                  self.group))
            ops.append(dist.P2POp(dist.irecv, from_below, self._peer(r - 1),
                                  self.group))
            self.bytes_sent["exchange"] += \
                down_w.numel() * down_w.element_size()
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()
        return self._back(from_below), self._back(from_above)

    def _peer(self, group_rank: int) -> int:
        """The global rank of a rank of the group."""
        if self.group is None:
            return group_rank
        return dist.get_global_rank(self.group, group_rank)

    def _all_reduce(self, t: torch.Tensor, op) -> torch.Tensor:
        w = self._wire(t).clone()
        self.bytes_sent["all_reduce"] += w.numel() * w.element_size()
        dist.all_reduce(w, op=op, group=self.group)
        return self._back(w)

    def sum(self, t: torch.Tensor) -> torch.Tensor:
        """``lax.psum``: the elementwise sum over the ranks, the same bits
        on every rank."""
        return self._all_reduce(t, dist.ReduceOp.SUM)

    def min(self, t: torch.Tensor) -> torch.Tensor:
        """``lax.pmin``."""
        return self._all_reduce(t, dist.ReduceOp.MIN)

    def gather_rows(self, x: torch.Tensor) -> torch.Tensor:
        """``lax.all_gather(x, tiled=True)`` along dim 0: every rank's
        block in rank order, on every rank."""
        w = self._wire(x)
        parts = [torch.empty_like(w) for _ in range(self.size)]
        dist.all_gather(parts, w, group=self.group)
        self.bytes_sent["all_gather"] += \
            (self.size - 1) * w.numel() * w.element_size()
        return self._back(torch.cat(parts, dim=0))

    def broadcast(self, t: torch.Tensor, src: int) -> torch.Tensor:
        """Rank ``src``'s tensor on every rank."""
        w = self._wire(t).clone()
        if self.rank == src:
            self.bytes_sent["broadcast"] += w.numel() * w.element_size()
        dist.broadcast(w, src=self._peer(src), group=self.group)
        return self._back(w)

    def barrier(self) -> None:
        dist.barrier(group=self.group)

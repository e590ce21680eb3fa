"""Process groups for data and tensor parallelism on ``torch.distributed``
(PyTorch port of ``lbt_tpu/parallel/multihost.py``).

One process per rank.  Launch every rank with the same command, for
example under ``torch.distributed.run``:

    python -m torch.distributed.run --nproc_per_node 2 \\
        -m lbt_tpu_torch.main --data_parallel ...

:func:`initialize` reads torchrun's ``MASTER_ADDR`` / ``MASTER_PORT`` /
``WORLD_SIZE`` / ``RANK`` / ``LOCAL_RANK`` (or ``lbt_tpu``'s
``COORDINATOR_ADDRESS`` / ``NUM_PROCESSES`` / ``PROCESS_ID``), joins the
group and returns a :class:`Group`: this rank's device, and the
collectives the data-parallel step calls (``parallel/mesh.py`` cuts the
world into data and model groups for tensor parallelism).  Each rank
reads and decodes only its own rows of a global batch
(:func:`host_batch_slice`); no rank decodes the whole batch.

The backend follows one rule: ``nccl`` when every rank on the host owns a
card of its own, ``gloo`` on the CPU or when ranks share a card (NCCL
refuses two ranks on one device).  Under gloo a CUDA tensor goes through
host memory for each collective (:meth:`Group.all_reduce`).  A failed
NCCL start raises; nothing retries with gloo.  Neither backend reduces
``int16`` (gloo raises ``Invalid scalar type``, NCCL has no such type), so
no collective here sends int16: the low-bit all-reduce sends int32 codes,
or int16 as bytes point to point (``parallel/lowbit.py``).
"""

from __future__ import annotations

import logging
import os
import time
from typing import Dict, List, Optional, Tuple

import torch
import torch.distributed as dist

__all__ = ["Group", "host_batch_slice", "initialize", "pick_backend"]

log = logging.getLogger("lbt_tpu_torch.parallel")


def _env(*names) -> Optional[str]:
    for n in names:
        v = os.environ.get(n)
        if v:
            return v
    return None


def pick_backend(device: torch.device, local_world: int) -> str:
    """``nccl`` when each of ``local_world`` ranks on this host owns a
    card, else ``gloo`` (the CPU, or ranks sharing a card)."""
    if device.type != "cuda":
        return "gloo"
    return "nccl" if local_world <= torch.cuda.device_count() else "gloo"


class Group:
    """A group of ranks as one of them sees it: ``rank``, ``world``,
    ``device`` and ``backend``, and the collectives of the step, each on
    this rank's tensor and returning the result.  Under gloo a CUDA
    tensor is copied to host memory, reduced there and copied back
    (gloo's own CUDA paths cover all-reduce only).  ``by_kind`` records,
    for the ``kind`` each call names, the host time spent in collectives,
    their number and the bytes of this rank's tensors (``[seconds, calls,
    bytes]``), for the step's metrics; ``seconds`` and ``calls`` are its
    totals."""

    def __init__(self, pg=None, device=None):
        self.pg = pg
        self.rank = dist.get_rank(pg)
        self.world = dist.get_world_size(pg)
        self.backend = str(dist.get_backend(pg))
        self.device = torch.device(device if device is not None else "cpu")
        self.by_kind: Dict[str, List[float]] = {}

    @property
    def seconds(self) -> float:
        return sum(k[0] for k in self.by_kind.values())

    @property
    def calls(self) -> int:
        return sum(k[1] for k in self.by_kind.values())

    def _staged(self, t: torch.Tensor) -> bool:
        return self.backend == "gloo" and t.device.type == "cuda"

    def _count(self, kind: str, t0: float, t: torch.Tensor) -> None:
        k = self.by_kind.setdefault(kind, [0.0, 0, 0])
        k[0] += time.perf_counter() - t0
        k[1] += 1
        k[2] += t.numel() * t.element_size()

    def all_reduce(self, t: torch.Tensor, op: str = "sum",
                   kind: str = "reduce") -> torch.Tensor:
        """``t`` reduced over the ranks (``op`` ``'sum'`` or ``'max'``);
        ``t`` itself is not written."""
        t0 = time.perf_counter()
        rop = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}[op]
        if self._staged(t):
            h = t.detach().to("cpu", copy=True)
            dist.all_reduce(h, rop, group=self.pg)
            out = h.to(t.device)
        else:
            out = t.detach().clone(memory_format=torch.contiguous_format)
            dist.all_reduce(out, rop, group=self.pg)
        self._count(kind, t0, t)
        return out

    def all_reduce_each(self, tensors) -> list:
        """Each of ``tensors`` (one dtype) summed over the ranks, in one
        all-reduce of a flat bucket."""
        flat = self.all_reduce(torch.cat([t.reshape(-1) for t in tensors]))
        parts = torch.split(flat, [t.numel() for t in tensors])
        return [v.view(t.shape) for v, t in zip(parts, tensors)]

    def mean(self, t: torch.Tensor, kind: str = "reduce") -> torch.Tensor:
        """XLA's ``pmean``: the sum over ranks, then divided by their
        number (exact for {0, 1} indicators)."""
        return self.all_reduce(t, kind=kind) / self.world

    def all_gather(self, t: torch.Tensor, dim: int = -1,
                   kind: str = "gather") -> torch.Tensor:
        """The ranks' tensors (one shape) joined along ``dim`` in rank
        order; under gloo a CUDA tensor goes through host memory."""
        t0 = time.perf_counter()
        src = t.detach().to("cpu") if self._staged(t) else t.detach()
        src = src.contiguous()
        parts = [torch.empty_like(src) for _ in range(self.world)]
        dist.all_gather(parts, src, group=self.pg)
        out = torch.cat(parts, dim)
        if self._staged(t):
            out = out.to(t.device)
        self._count(kind, t0, t)
        return out

    def ring_pass(self, send: torch.Tensor) -> torch.Tensor:
        """One hop of a ring: ``send`` goes to rank ``rank + 1``, and what
        rank ``rank - 1`` sent comes back (``lax.ppermute`` with the
        permutation ``j -> j + 1``).  Raw bytes on the wire, so any dtype
        passes either backend; a gloo CUDA tensor goes through host
        memory."""
        t0 = time.perf_counter()
        staged = self._staged(send)
        src = send.to("cpu") if staged else send
        wire = src.contiguous().view(torch.uint8)
        recv = torch.empty_like(wire)
        nxt, prv = (self.rank + 1) % self.world, (self.rank - 1) % self.world
        ops = [dist.P2POp(dist.isend, wire, self._global(nxt), self.pg),
               dist.P2POp(dist.irecv, recv, self._global(prv), self.pg)]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        out = recv.view(send.dtype).view(send.shape)
        if staged:
            out = out.to(send.device)
        self._count("ring", t0, send)
        return out

    def _global(self, rank: int) -> int:
        return rank if self.pg is None else dist.get_global_rank(self.pg,
                                                                  rank)


def initialize(device: Optional[str] = None,
               init_method: Optional[str] = None,
               world_size: Optional[int] = None,
               rank: Optional[int] = None) -> Group:
    """Join the data-parallel group and return it.

    ``world_size`` and ``rank`` come from the arguments, else torchrun's
    ``WORLD_SIZE`` / ``RANK``, else ``NUM_PROCESSES`` / ``PROCESS_ID``;
    the rendezvous is ``init_method`` (``'tcp://host:port'``,
    ``'file:///path'``), else ``tcp://MASTER_ADDR:MASTER_PORT``, else
    ``tcp://COORDINATOR_ADDRESS``.  ``device`` ``'cpu'`` runs on the CPU;
    otherwise the rank's card is ``cuda:LOCAL_RANK % device_count()``.
    ``LOCAL_RANK`` and ``LOCAL_WORLD_SIZE`` (torchrun sets both) default
    to the rank and the world, ranks on one host; under ``lbt_tpu``'s
    variables they default to 0 and 1: those count hosts, one process a
    host, so each process takes card 0 of its host and NCCL (several
    ranks a host: launch with torchrun, which sets ``LOCAL_*``).  The
    backend is :func:`pick_backend`'s, logged on rank 0; an NCCL start
    that fails raises."""
    # lbt_tpu's variables name the world: one process a host
    per_host = (world_size is None and _env("WORLD_SIZE") is None
                and _env("NUM_PROCESSES") is not None)
    world = int(world_size if world_size is not None
                else _env("WORLD_SIZE", "NUM_PROCESSES") or 1)
    rank = int(rank if rank is not None
               else _env("RANK", "PROCESS_ID") or 0)
    if init_method is None:
        addr, port = _env("MASTER_ADDR"), _env("MASTER_PORT")
        if addr and port:
            init_method = f"tcp://{addr}:{port}"
        elif _env("COORDINATOR_ADDRESS"):
            init_method = f"tcp://{_env('COORDINATOR_ADDRESS')}"
        else:
            raise RuntimeError(
                "no rendezvous: set MASTER_ADDR and MASTER_PORT (torchrun "
                "does) or COORDINATOR_ADDRESS, or pass init_method")
    local_rank = int(_env("LOCAL_RANK") or (0 if per_host else rank))
    local_world = int(_env("LOCAL_WORLD_SIZE") or (1 if per_host else world))
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("data parallelism on the card: no CUDA "
                               "device is available (pass device='cpu')")
        dev = torch.device("cuda", local_rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    backend = pick_backend(dev, local_world)
    kw = {"device_id": dev} if backend == "nccl" else {}
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world, rank=rank, **kw)
    if rank == 0:
        why = ("each rank owns a card" if backend == "nccl" else
               "ranks share a card" if dev.type == "cuda" else "the CPU")
        log.info("data parallel: %d ranks, backend %s (%s)", world,
                 backend, why)
    return Group(device=dev)


def host_batch_slice(global_batch: int,
                     group: Optional[Group] = None) -> Tuple[int, int]:
    """``(start, size)`` of this rank's rows of a global batch."""
    world = group.world if group is not None else dist.get_world_size()
    rank = group.rank if group is not None else dist.get_rank()
    if global_batch % world:
        raise ValueError(f"batch {global_batch} does not divide over "
                         f"{world} ranks")
    per = global_batch // world
    return rank * per, per

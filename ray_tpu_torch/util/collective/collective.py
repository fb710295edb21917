"""Collective groups between processes (the port of
``ray_tpu/util/collective/collective.py``).

Two tiers, as in the JAX package:

* **Device tier**: collectives inside a sharded program are item 7's
  (:mod:`ray_tpu_torch.parallel.axis` over a ``DeviceMesh``); nothing to
  initialize here.
* **Host tier** (this module): collectives between the runtime's
  processes (serve replicas, train workers, RL learners), arrays in and
  out as numpy, as JAX's. Each named group is a backend of its own built
  over a ``PrefixStore(<name>, store)``: gloo for host arrays, or NCCL
  (``backend="nccl"``) for arrays staged through the process's card. It
  is not the process's default group, so a process that already holds
  one (a ``TorchTrainer`` worker) joins named groups beside it, as many
  as it likes.

The rendezvous is a ``torch.distributed`` store where JAX's is a named
store actor (``_RendezvousStore``): pass ``store=`` (a ``TCPStore`` or
``FileStore`` every rank reaches) or ``init_method=`` (``"file://<path>"``
or ``"tcp://<host>:<port>"``, rank 0 hosting the TCP store).

Results are the rank-order numpy reduction JAX's group computes
(``np.sum(np.stack(parts), 0)`` and the rest) exactly on integer-valued
inputs; gloo sums floats in its own order. All ranks issue the same
sequence of collective ops (the collective-programming contract).
``broadcast`` and ``recv`` learn the array's shape and dtype from the
sender (a header before the data), so only the source needs it.
``reducescatter`` splits the reduced array as ``np.array_split`` does.
"""

from __future__ import annotations

import threading
import zlib
from datetime import timedelta
from typing import Dict, List, Optional
from urllib.parse import urlparse

import numpy as np
import torch
import torch.distributed as dist

# Seconds a collective round may wait for its peers (JAX's poll limit).
TIMEOUT_S = 120.0

_REDUCE_OPS = {
    "sum": dist.ReduceOp.SUM,
    "product": dist.ReduceOp.PRODUCT,
    "min": dist.ReduceOp.MIN,
    "max": dist.ReduceOp.MAX,
}

# A header names an array: ndim, dtype code, then its dims.
_HEADER = 16
_DTYPES = [np.dtype(t) for t in (
    "float32", "float64", "float16", "int8", "int16", "int32", "int64",
    "uint8", "bool")]


def _store_for(init_method: str, world_size: int, rank: int,
               timeout: timedelta):
    url = urlparse(init_method)
    if url.scheme == "file":
        return dist.FileStore(url.path, world_size)
    if url.scheme == "tcp":
        return dist.TCPStore(url.hostname, url.port, world_size,
                             is_master=rank == 0, timeout=timeout)
    raise ValueError(f"init_method must be file:// or tcp://, got "
                     f"{init_method!r}")


def _new_backend(backend: str, store, rank: int, world_size: int,
                 timeout: timedelta):
    if backend == "gloo":
        return dist.ProcessGroupGloo(store, rank, world_size, timeout)
    if backend == "nccl":
        opts = dist.ProcessGroupNCCL.Options()
        opts._timeout = timeout
        return dist.ProcessGroupNCCL(store, rank, world_size, opts)
    raise ValueError(f"backend must be 'gloo' or 'nccl', got {backend!r}")


class CollectiveGroup:
    """This process's handle to one named group (one rank of it)."""

    def __init__(self, name: str, world_size: int, rank: int, store,
                 backend: str = "gloo"):
        if not 0 <= rank < world_size:
            raise ValueError(f"rank {rank} not in a world of {world_size}")
        self.name = name
        self.world_size = world_size
        self.rank = rank
        self.backend = backend
        self.device = (torch.device("cuda", torch.cuda.current_device())
                       if backend == "nccl" else torch.device("cpu"))
        self._pg = _new_backend(backend,
                                dist.PrefixStore(f"collective/{name}",
                                                 store),
                                rank, world_size,
                                timedelta(seconds=TIMEOUT_S))
        self._lock = threading.Lock()
        # Sends in flight with the tensors they read: a send returns at
        # once, as JAX's store put does (gloo delivers it when the peer
        # posts its recv), and its buffers live until it completes.
        self._sends: List[tuple] = []

    # -- staging -----------------------------------------------------------
    def _tensor(self, array) -> torch.Tensor:
        a = np.ascontiguousarray(array)
        return torch.from_numpy(a.copy()).to(self.device)

    @staticmethod
    def _numpy(t: torch.Tensor) -> np.ndarray:
        return t.cpu().numpy()

    def _header(self, a: Optional[np.ndarray]) -> torch.Tensor:
        h = torch.zeros(_HEADER, dtype=torch.int64)
        if a is not None:
            if a.ndim > _HEADER - 2 or a.dtype not in _DTYPES:
                raise ValueError(f"cannot send a {a.dtype} array of "
                                 f"{a.ndim} dims")
            h[0], h[1] = a.ndim, _DTYPES.index(a.dtype)
            h[2:2 + a.ndim] = torch.tensor(a.shape, dtype=torch.int64)
        return h.to(self.device)

    @staticmethod
    def _empty_like_header(h: torch.Tensor, device) -> torch.Tensor:
        h = h.cpu().tolist()
        shape = tuple(h[2:2 + h[0]])
        return torch.from_numpy(np.zeros(shape, _DTYPES[h[1]])).to(device)

    def _run(self, work) -> None:
        work.wait()

    # -- ops ---------------------------------------------------------------
    def allgather(self, tensor) -> List[np.ndarray]:
        """Every rank's array, in rank order (the same shape and dtype on
        every rank)."""
        t = self._tensor(tensor)
        outs = [torch.empty_like(t) for _ in range(self.world_size)]
        with self._lock:
            self._run(self._pg.allgather([outs], [t]))
        return [self._numpy(o) for o in outs]

    def allreduce(self, tensor, op: str = "sum") -> np.ndarray:
        t = self._tensor(tensor)
        opts = dist.AllreduceOptions()
        opts.reduceOp = _REDUCE_OPS[op]
        with self._lock:
            self._run(self._pg.allreduce([t], opts))
        return self._numpy(t)

    def allreduce_tensor(self, tensor: torch.Tensor,
                         op: str = "sum") -> torch.Tensor:
        """``tensor`` reduced in place where it lies, with no host staging
        (a learner's gradient bucket): it must be on the group's device,
        this process's card on an NCCL group or the CPU on a gloo one.
        Returns it."""
        if tensor.device != self.device:
            raise ValueError(f"group {self.name!r} reduces on "
                             f"{self.device}, the tensor is on "
                             f"{tensor.device}")
        opts = dist.AllreduceOptions()
        opts.reduceOp = _REDUCE_OPS[op]
        with self._lock:
            self._run(self._pg.allreduce([tensor], opts))
        return tensor

    def reduce(self, tensor, dst_rank: int = 0, op: str = "sum"):
        """The reduction on ``dst_rank``; the input as it was elsewhere."""
        t = self._tensor(tensor)
        opts = dist.ReduceOptions()
        opts.rootRank, opts.reduceOp = dst_rank, _REDUCE_OPS[op]
        with self._lock:
            self._run(self._pg.reduce([t], opts))
        return self._numpy(t) if self.rank == dst_rank else tensor

    def broadcast(self, tensor, src_rank: int = 0) -> np.ndarray:
        """``src_rank``'s array on every rank (the others' ``tensor`` is
        ignored, as in JAX)."""
        src = np.asarray(tensor) if self.rank == src_rank else None
        opts = dist.BroadcastOptions()
        opts.rootRank = src_rank
        with self._lock:
            h = self._header(src)
            self._run(self._pg.broadcast([h], opts))
            t = (self._tensor(src) if src is not None
                 else self._empty_like_header(h, self.device))
            self._run(self._pg.broadcast([t], opts))
        return self._numpy(t)

    def reducescatter(self, tensor, op: str = "sum") -> np.ndarray:
        """This rank's ``np.array_split`` part of the reduction."""
        reduced = self.allreduce(tensor, op)
        return np.array_split(reduced, self.world_size)[self.rank]

    def barrier(self) -> None:
        with self._lock:
            self._run(self._pg.barrier(dist.BarrierOptions()))

    @staticmethod
    def _tag(tag: str) -> int:
        return zlib.crc32(str(tag).encode()) & 0x3FFFFFFF

    def send(self, tensor, dst_rank: int, tag: str = "") -> None:
        """Point to point, FIFO per (peer, tag): a header, then the data.
        On gloo it returns without waiting for the peer's recv; NCCL
        completes a send only when its peer receives, so two NCCL ranks
        that exchange order their calls (one sends first)."""
        a = np.asarray(tensor)
        t = self._tag(tag)
        self._sends = [s for s in self._sends if not s[0].is_completed()]
        for buf in (self._header(a), self._tensor(a)):
            self._sends.append((self._pg.send([buf], dst_rank, t), buf))

    def recv(self, src_rank: int, tag: str = "") -> np.ndarray:
        t = self._tag(tag)
        h = self._header(None)
        self._run(self._pg.recv([h], src_rank, t))
        out = self._empty_like_header(h, self.device)
        self._run(self._pg.recv([out], src_rank, t))
        return self._numpy(out)

    def destroy(self) -> None:
        for work, _ in self._sends:
            work.wait()
        self._sends = []
        try:
            self._pg.shutdown()
        except Exception:  # noqa: BLE001 - a backend without shutdown
            pass


class GroupManager:
    """Process-local registry of collective groups (reference
    ``collective.py:40``)."""

    def __init__(self):
        self._groups: Dict[str, CollectiveGroup] = {}
        self._lock = threading.Lock()

    def create_group(self, name: str, world_size: int, rank: int, *,
                     store=None, init_method: Optional[str] = None,
                     backend: str = "gloo") -> CollectiveGroup:
        with self._lock:
            if name in self._groups:
                raise ValueError(f"collective group {name!r} is already "
                                 f"initialized in this process")
        if store is None:
            if init_method is None:
                raise ValueError(
                    "init_collective_group needs a rendezvous: store= (a "
                    "torch.distributed store every rank reaches) or "
                    "init_method= ('file://<path>' or 'tcp://<host>:<port>')")
            store = _store_for(init_method, world_size, rank,
                               timedelta(seconds=TIMEOUT_S))
        group = CollectiveGroup(name, world_size, rank, store, backend)
        with self._lock:
            self._groups[name] = group
        return group

    def get_group(self, name: str) -> CollectiveGroup:
        try:
            return self._groups[name]
        except KeyError:
            raise ValueError(
                f"collective group {name!r} is not initialized") from None

    def destroy_group(self, name: str) -> None:
        with self._lock:
            group = self._groups.pop(name, None)
        if group is not None:
            group.destroy()


_manager = GroupManager()


def init_collective_group(world_size: int, rank: int,
                          group_name: str = "default", *, store=None,
                          init_method: Optional[str] = None,
                          backend: str = "gloo") -> CollectiveGroup:
    """Join group ``group_name`` as ``rank`` of ``world_size``; returns
    once every rank joined."""
    return _manager.create_group(group_name, world_size, rank, store=store,
                                 init_method=init_method, backend=backend)


def destroy_collective_group(group_name: str = "default") -> None:
    _manager.destroy_group(group_name)


def is_group_initialized(group_name: str = "default") -> bool:
    try:
        _manager.get_group(group_name)
        return True
    except ValueError:
        return False


def get_rank(group_name: str = "default") -> int:
    return _manager.get_group(group_name).rank


def get_collective_group_size(group_name: str = "default") -> int:
    return _manager.get_group(group_name).world_size


def allreduce(tensor, group_name: str = "default", op: str = "sum"):
    return _manager.get_group(group_name).allreduce(tensor, op)


def allgather(tensor, group_name: str = "default"):
    return _manager.get_group(group_name).allgather(tensor)


def reduce(tensor, dst_rank: int = 0, group_name: str = "default",
           op: str = "sum"):
    return _manager.get_group(group_name).reduce(tensor, dst_rank, op)


def broadcast(tensor, src_rank: int = 0, group_name: str = "default"):
    return _manager.get_group(group_name).broadcast(tensor, src_rank)


def reducescatter(tensor, group_name: str = "default", op: str = "sum"):
    return _manager.get_group(group_name).reducescatter(tensor, op)


def send(tensor, dst_rank: int, group_name: str = "default", tag: str = ""):
    return _manager.get_group(group_name).send(tensor, dst_rank, tag)


def recv(src_rank: int, group_name: str = "default", tag: str = ""):
    return _manager.get_group(group_name).recv(src_rank, tag)


def barrier(group_name: str = "default"):
    return _manager.get_group(group_name).barrier()

"""LearnerGroup: data-parallel learners with one bucketed gradient
allreduce an update (the port of ``ray_tpu/rllib/learner_group.py``).

Reference: ``rllib/core/learner/learner_group.py:80``. N learners each
hold a replica of the module; every update computes gradients on a shard
of the batch, allreduces them, and applies locally, so weights stay bit
for bit the same across learners without a broadcast.

The JAX package hosts each learner in an actor. On a cluster
(``ray_tpu_torch.init(address=...)``) so does the port: an actor of the
cluster runtime with ``num_gpus=1`` (``0`` with ``use_gpu=False``) that
the GCS places and its node gives its card
(:class:`~ray_tpu_torch.runtime.cluster_replica.ClusterReplica`).
Otherwise each learner lives in a
:class:`~ray_tpu_torch.runtime.replica.ReplicaProcess`, forked from the
runtime's fork server as train workers are, each on a card of this host
(``CUDA_VISIBLE_DEVICES``; an empty one with ``use_gpu=False``). The
allreduce runs on a named collective group
(:mod:`ray_tpu_torch.util.collective`) whose rendezvous is a ``TCPStore``
this process hosts, on its host's address as the cluster runtime knows
it: NCCL over the learners' cards, the fp32 gradient
bucket reduced where the grads lie, or gloo for CPU learners. The learner builder crosses by
``(module, qualname)``, so it must be defined at module level; JAX's
closures become a module-level builder (a learner class) and its
``builder_args`` / ``builder_kwargs``, which cross by pickle. Weights
come back through a shared-memory channel sized to the tree, not the
pipe: a pickle of GBs through the pipe held the serving process's GIL
long enough for its health probes to give up on live replicas.
"""

from __future__ import annotations

import logging
import os
import uuid
from concurrent.futures import Future
from typing import Any, Dict, List

import numpy as np
import torch

from ray_tpu_torch._private import chaos
from ray_tpu_torch.rl.weight_sync import _flat, _nest

logger = logging.getLogger(__name__)

#: Seconds a learner process may take to build its learner.
LEARNER_START_S = 600.0


def _grad_bucket(pairs, device) -> torch.Tensor:
    """Gradient leaves as one fp32 vector on ``device`` (bf16 widened, so
    the reduction sums in fp32 on either backend)."""
    return torch.cat([g.detach().reshape(-1).to(device, torch.float32)
                      for _, g in pairs])


def _host_np(x) -> np.ndarray:
    """A grad leaf as host numpy for the allreduce (bf16 widened to
    fp32: numpy has no bf16)."""
    if isinstance(x, torch.Tensor):
        x = x.detach()
        if x.dtype == torch.bfloat16:
            x = x.float()
        return x.cpu().numpy()
    return np.asarray(x)


def _bytes(x) -> bytes:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().contiguous().reshape(-1).view(
            torch.uint8).numpy().tobytes()
    return np.ascontiguousarray(x).tobytes()


def _sig(x):
    return tuple(x.shape), str(x.dtype)


def _pack(tree):
    """A weight tree for a channel: its leaves as numpy arrays (a bf16
    tensor as its uint16 bits, so the pickle writes it straight into the
    segment) and each leaf's kind (its torch dtype, or numpy)."""
    pairs, kinds = [], []
    for path, leaf in _flat(tree):
        if isinstance(leaf, torch.Tensor):
            kinds.append(str(leaf.dtype))
            leaf = leaf.detach().cpu().contiguous()
            if leaf.dtype == torch.bfloat16:
                leaf = leaf.view(torch.uint16)
            leaf = leaf.numpy()
        else:
            kinds.append("numpy")
        pairs.append((path, leaf))
    return _nest(pairs), kinds


def _unpack(payload):
    """The tree :func:`_pack` packed (tensors as tensors again)."""
    wire, kinds = payload
    out = []
    for (path, leaf), kind in zip(_flat(wire), kinds):
        if kind != "numpy":
            leaf = torch.from_numpy(leaf)
            if kind == "torch.bfloat16":
                leaf = leaf.view(torch.bfloat16)
        out.append((path, leaf))
    return _nest(out)


class _LearnerActor:
    """One learner, inside its process."""

    def __init__(self, builder_ref, rank: int, world_size: int,
                 group_name: str, store_address: str,
                 backend: str = "gloo", builder_args=(),
                 builder_kwargs=None):
        from ray_tpu_torch.runtime.replica import resolve

        # Same seed inside the builder -> identical initial replicas.
        self.learner = resolve(builder_ref)(*builder_args,
                                            **(builder_kwargs or {}))
        self.rank = rank
        self.world_size = world_size
        self.group = None
        if world_size > 1:
            import torch.distributed as dist

            from ray_tpu_torch.util.collective import init_collective_group

            host, port = store_address.rsplit(":", 1)
            store = dist.TCPStore(host, int(port), is_master=False)
            self.group = init_collective_group(world_size, rank, group_name,
                                               backend=backend, store=store)

    def update_many(self, shards) -> Dict[str, float]:
        """Apply a sequence of update batches in one call; collective
        ordering stays aligned because every learner receives the same
        number of shards in the same order."""
        metrics: Dict[str, float] = {}
        for shard in shards:
            metrics = self.update(shard)
        return metrics

    def update(self, shard) -> Dict[str, float]:
        grads, metrics = self.learner.compute_gradients(shard)
        if self.group is not None:
            grads = self._allreduce(grads)
        self.learner.apply_gradients(grads)
        return metrics

    def _allreduce(self, grads):
        """The group's mean of ``grads`` in ONE allreduce: the leaves
        flattened into one vector (bucketing), not reduced leaf by leaf.
        Tensor grads reduce as an fp32 bucket on the group's device (on
        the card over NCCL); numpy grads go through the host, as JAX's."""
        pairs = _flat(grads)
        if all(isinstance(g, torch.Tensor) for _, g in pairs):
            flat = self.group.allreduce_tensor(
                _grad_bucket(pairs, self.group.device))
            flat /= self.world_size
            out, off = [], 0
            for path, g in pairs:
                out.append((path, flat[off:off + g.numel()].view(
                    g.shape).to(g.dtype)))
                off += g.numel()
            return _nest(out)
        arrs = [_host_np(g) for _, g in pairs]
        flat = np.concatenate([a.ravel() for a in arrs])
        reduced = self.group.allreduce(flat) / self.world_size
        out, off = [], 0
        for (path, g), a in zip(pairs, arrs):
            part = reduced[off:off + a.size].reshape(a.shape)
            off += a.size
            if isinstance(g, torch.Tensor):
                part = torch.from_numpy(np.ascontiguousarray(
                    part.astype(a.dtype))).to(g.dtype)
            else:
                part = part.astype(a.dtype)
            out.append((path, part))
        return _nest(out)

    def get_weights(self):
        weights = self.learner.get_weights()
        if chaos.enabled():
            # Cooperative divergence fault: a matched rank hands back
            # weights nudged by eps. The learner's OWN replica stays
            # intact; the fault is in what it reports, the silent skew
            # the group's bit-identity check targets.
            directive = chaos.inject("learner_weights", rank=self.rank)
            if directive and "perturb" in directive:
                eps = directive["perturb"]
                weights = _nest([
                    (p, w + eps if isinstance(w, torch.Tensor)
                     else np.asarray(w) + np.asarray(eps, np.asarray(
                         w).dtype)) for p, w in _flat(weights)])
        return weights

    def export_weights(self):
        """:meth:`get_weights` through a shared-memory channel sized to
        the tree: returns its reader's attach-spec (the tree itself, GBs
        at a model's widths, never crosses the pipe). The channel lives
        until the next export; the reader unlinks it."""
        from ray_tpu_torch.experimental.channel import Channel, _pickle_into

        payload = _pack(self.get_weights())
        if getattr(self, "_export", None) is not None:
            self._export.destroy()
        self._export = Channel(capacity=_pickle_into(payload), n_readers=1)
        self._export.write(payload)
        return self._export.reader(0)

    def set_weights(self, weights):
        self.learner.set_weights(weights)
        return True

    def ping(self):
        return True


class LearnerGroup:
    """Drives N learner processes as one logical learner.

    ``learner_builder``: a module-level callable (a class or function)
    returning a learner with ``compute_gradients`` / ``apply_gradients``
    / ``get_weights`` / ``set_weights``, called in each learner process
    as ``learner_builder(*builder_args, **builder_kwargs)`` (both
    pickled). ``use_gpu`` (default on) gives
    each learner a card of its own, their allreduce over NCCL, and
    raises on a host without one;
    ``use_gpu=False`` runs CPU learners (their builder asks for the
    CPU)."""

    def __init__(self, learner_builder, num_learners: int = 1, *,
                 use_gpu: bool = True, builder_args=(),
                 builder_kwargs=None):
        import torch.distributed as dist

        from ray_tpu_torch.runtime.cluster_replica import (ClusterReplica,
                                                           cluster_core,
                                                           driver_host)
        from ray_tpu_torch.runtime.replica import ReplicaProcess, reference

        try:
            ref = reference(learner_builder)
        except ValueError as e:
            raise ValueError(
                f"learner_builder {learner_builder!r} cannot cross to the "
                f"learner processes: define it at module level of an "
                f"importable module ({e})") from e
        self.num_learners = max(int(num_learners), 1)
        n = self.num_learners
        group_name = f"learner_group_{uuid.uuid4().hex[:8]}"
        on_cluster = cluster_core() is not None
        envs = [] if on_cluster else self._host_envs(n, use_gpu)
        # The allreduce's rendezvous, hosted here for the group's life.
        host = driver_host()
        self._store = dist.TCPStore(host, 0, is_master=True,
                                    wait_for_workers=False)
        address = f"{host}:{self._store.port}"
        self.learners: List[ReplicaProcess] = []
        try:
            for rank in range(n):
                args = (ref, rank, n, group_name, address,
                        "nccl" if use_gpu else "gloo", tuple(builder_args),
                        dict(builder_kwargs or {}))
                if on_cluster:
                    self.learners.append(ClusterReplica(
                        "learner", _LearnerActor, args, {}, False,
                        sync_workers=2, control_slots=0, actor_options={
                            "num_cpus": 1, "num_gpus": 1 if use_gpu
                            else 0}))
                else:
                    self.learners.append(ReplicaProcess(
                        "learner", _LearnerActor, args, {}, False,
                        sync_workers=2, env=envs[rank]))
            for w in self.learners:
                w.wait_ready(LEARNER_START_S)
        except BaseException:
            self.shutdown()
            raise
        self._push_chaos()
        chaos.subscribe(self._push_chaos)

    @staticmethod
    def _host_envs(n: int, use_gpu: bool) -> List[Dict[str, str]]:
        """Each forked learner's ``CUDA_VISIBLE_DEVICES``: a card of this
        host each, or none."""
        from ray_tpu_torch.runtime.controller import _place
        from ray_tpu_torch.train.backend_executor import visible_cards

        if not use_gpu:
            return [{"CUDA_VISIBLE_DEVICES": ""} for _ in range(n)]
        if not torch.cuda.is_available():
            raise RuntimeError(
                "LearnerGroup(use_gpu=True) but this host has no CUDA "
                "card; pass use_gpu=False (and a builder whose learner "
                "asks for the CPU) to learn in CPU processes")
        cards, use, envs = visible_cards(), {}, []
        for _ in range(n):
            got = _place(use, cards, 1.0)
            if got is None:
                raise RuntimeError(
                    f"{n} learners of a card each do not fit the "
                    f"host's cards {cards}")
            envs.append({"CUDA_VISIBLE_DEVICES": ",".join(got)})
        return envs

    def _push_chaos(self) -> None:
        shared = chaos.state()
        for w in self.learners:
            w.push_chaos(shared)

    @staticmethod
    def _results(futures: List[Future], timeout_s: float) -> List[Any]:
        return [f.result(timeout=timeout_s) for f in futures]

    def _call(self, method: str, per_learner_args, timeout_s: float):
        return self._results([w.call(method, args, {}) for w, args in
                              zip(self.learners, per_learner_args)],
                             timeout_s)

    @staticmethod
    def _shard(batch, n: int) -> List[Any]:
        if n == 1:
            return [batch]
        if isinstance(batch, dict):
            # [T, N] trajectory dict: shard along the env axis;
            # bootstrap_obs is [N]-leading.
            size = batch["actions"].shape[1]
            if size < n:
                # Fewer envs than learners: every learner grads the full
                # batch, so the allreduce average equals one learner's.
                return [batch] * n
            bounds = [size * i // n for i in range(n + 1)]
            out = []
            for i in range(n):
                lo, hi = bounds[i], bounds[i + 1]
                out.append({k: (v[lo:hi] if k == "bootstrap_obs"
                                else v[:, lo:hi])
                            for k, v in batch.items()})
            return out
        size = len(batch.obs)
        if size < n:
            return [batch] * n
        bounds = [size * i // n for i in range(n + 1)]
        return [type(batch)(*[f[bounds[i]:bounds[i + 1]] for f in batch])
                for i in range(n)]

    def update(self, batch) -> Dict[str, float]:
        """One synchronized update over all learners; returns rank 0's
        metrics."""
        shards = self._shard(batch, self.num_learners)
        return self._call("update", [(s,) for s in shards], 300)[0]

    def update_many(self, batches) -> Dict[str, float]:
        """Many update batches with ONE call per learner."""
        per_learner = [[] for _ in range(self.num_learners)]
        for batch in batches:
            for i, shard in enumerate(self._shard(batch,
                                                  self.num_learners)):
                per_learner[i].append(shard)
        return self._call("update_many", [(s,) for s in per_learner],
                          600)[0]

    def get_weights(self):
        """Weights of the logical learner.

        The allreduce makes every learner's replica bit-identical, so one
        read (learner 0) suffices. Under a chaos plan or
        ``RAY_TPU_RL_DEBUG=1`` that invariant is VERIFIED: all learners
        are read and compared leaf by leaf, byte for byte, and a diverged
        one fails loudly here (``rl.learner_divergence``)."""
        if not (chaos.enabled() or os.environ.get("RAY_TPU_RL_DEBUG")):
            return self._read_export(self._call("export_weights", [()],
                                                600)[0])
        all_weights = self.get_all_weights()
        self._check_bit_identity(all_weights)
        return all_weights[0]

    def _check_bit_identity(self, all_weights: List[Any]) -> None:
        from ray_tpu_torch._private import events as _events

        ref = _flat(all_weights[0])
        for rank, weights in enumerate(all_weights[1:], start=1):
            leaves = _flat(weights)
            if [p for p, _ in leaves] != [p for p, _ in ref]:
                raise RuntimeError(
                    f"learner {rank} weight tree structure diverged from "
                    f"learner 0")
            for i, ((_, a), (_, b)) in enumerate(zip(ref, leaves)):
                if _sig(a) != _sig(b) or _bytes(a) != _bytes(b):
                    _events.emit("rl.learner_divergence",
                                 subject={"group": "learners"},
                                 rank=rank, leaf=i)
                    raise RuntimeError(
                        f"learner {rank} weights diverged from learner 0 "
                        f"at leaf {i} (shape {tuple(b.shape)}, dtype "
                        f"{b.dtype}): the allreduce bit-identity invariant "
                        f"is broken")

    def get_all_weights(self) -> List[Any]:
        return [self._read_export(spec) for spec in self._call(
            "export_weights", [()] * self.num_learners, 600)]

    @staticmethod
    def _read_export(spec):
        try:
            return _unpack(spec.read(timeout=600))
        finally:
            spec.destroy()

    def set_weights(self, weights) -> None:
        self._call("set_weights", [(weights,)] * self.num_learners, 120)

    def shutdown(self) -> None:
        """Kill the learner processes and wait for them."""
        chaos.unsubscribe(self._push_chaos)
        for w in self.learners:
            try:
                w.kill()
            except Exception:  # noqa: BLE001 - teardown must proceed
                logger.exception("learner teardown failed")
        self.learners = []

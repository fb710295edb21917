"""Sharded train step for the Llama family (port of
``ray_tpu/models/training.py``).

:class:`ShardedTrainer` keeps the JAX trainer's interface: ``init_state``,
``train_step`` with token-weighted gradient accumulation over
microbatches, ``shard_batch`` and ``metrics["grad_norm"]``. On a
:class:`~torch.distributed.device_mesh.DeviceMesh`
(:func:`ray_tpu_torch.parallel.make_mesh`) params and moments are
DTensors placed by the logical-axis rule table, the batch is split over
(data, fsdp), and each grad is redistributed to its param's placements
before the optimizer sees it: the reduce-scatter or all-reduce that the
JAX step's ``out_shardings`` imply. Without a mesh the step runs on one
device. ``save_state``/``restore_state`` go through the checkpoint plane
(:mod:`ray_tpu_torch.checkpoint`), whose files the JAX package's plane
writes too.

:func:`default_optimizer` is optax's ``chain(clip_by_global_norm,
adamw(warmup_cosine_decay_schedule))`` written out in PyTorch with the
same arithmetic, leaf by leaf: the train step updates params and
moments in place (JAX donates the state the same way), so the optimizer
never holds a second copy of the model.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed
from torch.distributed.tensor import DTensor, Replicate, distribute_tensor

from ray_tpu_torch._private import cuda_monitor
from ray_tpu_torch.models import llama
from ray_tpu_torch.parallel import sharding as shd


def _leaves(tree) -> List[torch.Tensor]:
    """Tensors of nested dicts (insertion order) and lists."""
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _leaves(v)]
    return [tree]


def _unflatten(tree, leaves):
    it = iter(leaves)

    def build(node):
        if isinstance(node, dict):
            return {k: build(v) for k, v in node.items()}
        return next(it)
    return build(tree)


@dataclasses.dataclass
class OptState:
    """AdamW state: ``count`` updates taken, and the moments ``mu`` and
    ``nu`` (lists in the params' leaf order)."""
    count: int
    mu: List[torch.Tensor]
    nu: List[torch.Tensor]


class AdamW:
    """``optax.chain(clip_by_global_norm(grad_clip), adamw(schedule, b1,
    b2, eps=1e-8, weight_decay, mu_dtype))`` with the schedule
    ``warmup_cosine_decay_schedule(0, lr, warmup, decay_steps)``:

    * clip: ``g`` when ``||g|| < grad_clip``, else ``(g / ||g||) *
      grad_clip`` (the norm over every leaf);
    * moments ``mu = (1 - b1) g + b1 mu``, ``nu = (1 - b2) g^2 + b2 nu``,
      both in the params' dtype (``mu_dtype`` can raise the first only);
    * bias correction by the incremented count, ``1 - b**count`` in fp32
      cast to the moment's dtype; ``u = mu_hat / (sqrt(nu_hat) + eps)``;
    * decoupled weight decay ``u + weight_decay * p`` on every leaf, then
      ``-lr(count) * u`` with the schedule read at the count *before*
      the increment (so step 1 runs at lr 0), in the update's dtype;
    * ``p + u`` cast back to p's dtype.

    optax keeps two counters (adam's and the schedule's) that move
    together; one ``count`` stands for both here.
    """

    def __init__(self, learning_rate, weight_decay, b1, b2, grad_clip,
                 warmup_steps, decay_steps, mu_dtype=None, eps=1e-8):
        self.learning_rate = learning_rate
        self.weight_decay = weight_decay
        self.b1, self.b2, self.eps = b1, b2, eps
        self.grad_clip = grad_clip
        self.warmup_steps = warmup_steps
        self.decay_steps = decay_steps
        self.mu_dtype = mu_dtype

    def schedule(self, count: int) -> np.float32:
        """``warmup_cosine_decay_schedule(0, lr, warmup, decay_steps)`` at
        ``count``, in fp32 as optax computes it."""
        f32 = np.float32
        w, lr = self.warmup_steps, self.learning_rate
        if count < w:
            frac = f32(1) - f32(min(max(count, 0), w)) / f32(w)
            return f32(0.0 - lr) * frac + f32(lr)
        t = f32(min(count - w, self.decay_steps - w))
        cosine = f32(0.5) * (f32(1) + np.cos(f32(math.pi) * t
                                             / f32(self.decay_steps - w)))
        return f32(lr) * (f32(1) * cosine + f32(0))

    def init(self, params) -> OptState:
        leaves = _leaves(params)
        return OptState(
            count=0,
            mu=[torch.zeros_like(p, dtype=self.mu_dtype or p.dtype)
                for p in leaves],
            nu=[torch.zeros_like(p) for p in leaves])

    @staticmethod
    def global_norm(grads) -> torch.Tensor:
        """sqrt of the sum of squares over every leaf, in fp32 (a leaf
        piece by piece, :func:`_pieces`). DTensor leaves are summed on
        each rank's local shard; a leaf replicated on a mesh dim counts
        only from the ranks at coordinate 0 there, so it counts once. One
        all-reduce over the mesh of a sum per placement pattern, added up
        in one order: the same plain tensor on every rank."""
        leaves = _leaves(grads)
        if not any(isinstance(g, DTensor) for g in leaves):
            return torch.sqrt(sum(_square_sum(g) for g in leaves))
        mesh = leaves[0].device_mesh
        if mesh.size() != torch.distributed.get_world_size():
            raise ValueError("global_norm needs a mesh over every rank")
        coord = mesh.get_coordinate()
        patterns, sums = [], []
        for g in leaves:
            if g.device_mesh != mesh or any(p.is_partial()
                                            for p in g.placements):
                raise ValueError("global_norm takes grads on one mesh in "
                                 "their params' placements")
            split = tuple(p.is_shard() for p in g.placements)
            if split not in patterns:
                patterns.append(split)
                sums.append(0.0)
            if all(s or c == 0 for s, c in zip(split, coord)):
                i = patterns.index(split)
                sums[i] = sums[i] + _square_sum(g.to_local())
        total = torch.stack([torch.as_tensor(s, dtype=torch.float32,
                                             device=leaves[0].device)
                             for s in sums])
        torch.distributed.all_reduce(total)
        return torch.sqrt(sum(total.unbind()))

    def _leaf(self, g, mu, nu, p, g_norm, clip, count_inc, step_size):
        """One leaf's (update, new mu, new nu)."""
        if clip:
            g = (g / g_norm.to(g.dtype)) * self.grad_clip
        mu = (1 - self.b1) * g + self.b1 * mu
        nu = (1 - self.b2) * (g * g) + self.b2 * nu
        f32 = np.float32
        bc1 = f32(1) - f32(self.b1) ** f32(count_inc)
        bc2 = f32(1) - f32(self.b2) ** f32(count_inc)
        mu_hat = mu / _rounded(bc1, mu.dtype)
        nu_hat = nu / _rounded(bc2, nu.dtype)
        u = mu_hat / (torch.sqrt(nu_hat) + self.eps)
        u = u + self.weight_decay * p
        u = _rounded(step_size, u.dtype) * u
        return u, mu.to(self.mu_dtype or mu.dtype), nu

    def _begin(self, grads, state, g_norm=None):
        if g_norm is None:
            g_norm = self.global_norm(grads)
        clip = not bool(g_norm < self.grad_clip)
        step_size = -self.schedule(state.count)
        return g_norm, clip, state.count + 1, step_size

    @torch.no_grad()
    def update(self, grads, state: OptState, params):
        """optax's ``update``: (updates in the params' nesting, new
        state); nothing is modified."""
        g_norm, clip, count_inc, step_size = self._begin(grads, state)
        out = [self._leaf(g, mu, nu, p, g_norm, clip, count_inc, step_size)
               for g, mu, nu, p in zip(_leaves(grads), state.mu, state.nu,
                                       _leaves(params))]
        return (_unflatten(params, [u for u, _, _ in out]),
                OptState(count_inc, [m for _, m, _ in out],
                         [n for _, _, n in out]))

    @torch.no_grad()
    def apply_(self, grads, state: OptState, params,
               g_norm: Optional[torch.Tensor] = None) -> OptState:
        """``update`` and ``apply_updates`` in place, one piece of a leaf
        at a time (:func:`_pieces`; the arithmetic is elementwise, so the
        values are the whole leaf's): params, mu and nu are overwritten,
        so no piece's temporaries outlive it. ``g_norm``: the grads'
        global norm, when the caller has it."""
        g_norm, clip, count_inc, step_size = self._begin(grads, state,
                                                         g_norm)
        for leaf in zip(_leaves(grads), state.mu, state.nu,
                        _leaves(params)):
            leaf = _local_views(leaf)
            if all(t.is_contiguous() for t in leaf):
                leaf = [_pieces(t) for t in leaf]
            else:
                leaf = [(t,) for t in leaf]
            for g, mu, nu, p in zip(*leaf):
                u, mu_new, nu_new = self._leaf(g, mu, nu, p, g_norm, clip,
                                               count_inc, step_size)
                p.copy_((p + u).to(p.dtype))
                mu.copy_(mu_new)
                nu.copy_(nu_new)
        state.count = count_inc
        return state


# Elements of a leaf that one pass of the optimizer's elementwise work
# takes at a time: its temporaries (about eight of a piece's size) stay
# near 1 GiB in bf16 however large the leaf. A Mixtral-8x7B expert leaf
# of 4 layers holds 1.9 G elements (3.8 GB in bf16).
_PIECE = 1 << 26


def _square_sum(t: torch.Tensor) -> torch.Tensor:
    return sum(piece.float().square().sum() for piece in _pieces(t))


def _local_views(tensors):
    """Each rank's local tensors of DTensors that share one placement
    (the optimizer's work is elementwise); plain tensors as they are."""
    if not isinstance(tensors[0], DTensor):
        return tensors
    placements = {tuple(t.placements) for t in tensors}
    if len(placements) != 1:
        raise ValueError(f"param, grad and moments differ in placements "
                         f"{placements}")
    return [t.to_local() for t in tensors]


def _pieces(t: torch.Tensor):
    """Flat views of a contiguous ``t``, in order, of at most ``_PIECE``
    elements each; the whole of ``t`` otherwise."""
    return t.view(-1).split(_PIECE) if t.is_contiguous() else (t,)


def _rounded(x, dtype) -> float:
    """fp32 scalar ``x`` rounded to ``dtype``, as a Python float (optax
    casts its scalars to the operand's dtype)."""
    return float(torch.tensor(x, dtype=torch.float32).to(dtype))


def default_optimizer(learning_rate: float = 3e-4,
                      weight_decay: float = 0.1, b1: float = 0.9,
                      b2: float = 0.95, grad_clip: float = 1.0,
                      warmup_steps: int = 100, total_steps: int = 10000,
                      mu_dtype=None) -> AdamW:
    """AdamW with warmup-cosine, as the JAX package's: both moments in
    the params' dtype (bf16 for bf16 params) unless ``mu_dtype`` raises
    the first."""
    return AdamW(learning_rate, weight_decay, b1, b2, grad_clip,
                 warmup_steps, max(total_steps, warmup_steps + 1),
                 mu_dtype=mu_dtype)


def apply_updates(params, updates):
    """optax's ``apply_updates``: ``p + u`` cast to p's dtype."""
    return _unflatten(params, [(p + u).to(p.dtype) for p, u in
                               zip(_leaves(params), _leaves(updates))])


@dataclasses.dataclass
class TrainState:
    step: int
    params: Any
    opt_state: OptState


BATCH_SPEC = (("data", "fsdp"),)


def _divisible_spec(spec, shape, mesh):
    """Drop mesh axes from ``spec`` where they do not divide the dim
    (``mesh``: a DeviceMesh or a mapping of axis sizes)."""
    return shd.divisible_spec(spec, shape, llama.mesh_shape(mesh))


def _mesh_device(mesh, device) -> torch.device:
    kind = mesh.device_type
    want = torch.device(kind, torch.cuda.current_device()) \
        if kind == "cuda" else torch.device(kind)
    if device is not None and torch.device(device).type != kind:
        raise ValueError(f"device {device} is not the mesh's {kind!r}")
    return want


def _plain(t):
    """A DTensor's global value as a plain tensor on every rank."""
    return t.full_tensor() if isinstance(t, DTensor) else t


class ShardedTrainer:
    """The JAX trainer's train step, on one device or on a mesh.

    ``mesh``: a DeviceMesh from :func:`ray_tpu_torch.parallel.make_mesh`
    (params, moments and batch sharded by ``rules``, default
    :data:`~ray_tpu_torch.parallel.DEFAULT_RULES`), or None or a mapping
    of axis sizes whose product is 1 (one device). ``device`` defaults to
    ``cuda`` (raises without a GPU; pass ``device="cpu"`` for the plain
    path); on a mesh it is the mesh's device.
    """

    def __init__(self, config: llama.LlamaConfig, mesh=None,
                 optimizer: Optional[AdamW] = None, rules=None,
                 microbatches: int = 1, grad_accum_dtype: Any = None,
                 device=None):
        if llama.on_mesh(mesh):
            device = _mesh_device(mesh, device)
        elif math.prod(llama.mesh_shape(mesh).values()) > 1:
            raise ValueError(
                f"a mesh of more than one device ({llama.mesh_shape(mesh)})"
                f" must be a DeviceMesh from ray_tpu_torch.parallel."
                f"make_mesh, not a mapping of sizes")
        self.config = config
        self.mesh = mesh
        self.rules = rules
        self.device = llama.default_device(device)
        self.optimizer = optimizer or default_optimizer()
        # Token-weighted accumulation over M microbatches, one optimizer
        # update; the accumulator is fp32 unless asked otherwise.
        self.microbatches = max(int(microbatches), 1)
        self.grad_accum_dtype = grad_accum_dtype or torch.float32
        self.param_specs = self.param_placements = None
        if llama.on_mesh(mesh):
            # A mesh axis that does not divide a dim (2 kv heads on
            # tensor=4) leaves that dim replicated, as GSPMD requires.
            self.param_specs = shd.tree_map(
                lambda spec, shape: _divisible_spec(spec, shape, mesh),
                shd.tree_specs(llama.logical_axes(config), rules),
                llama.param_shapes(config))
            self.param_placements = shd.tree_map(
                lambda spec: shd.spec_placements(spec, mesh),
                self.param_specs)
        # The profiling plane's programs (JAX's names): the first step at
        # a batch shape is its compile, counted for FLOPs and bytes; a
        # loop that syncs per step feeds the achieved gauges by call
        # cadence, AsyncStepLoop by its measured window.
        self._init = cuda_monitor.instrument(
            self._init_state, name="train_init", shape_policy="free",
            device=self.device)
        self._step = cuda_monitor.instrument(
            self._train_step, name="train_step", device=self.device)

    # -- state -------------------------------------------------------------
    def state_from_params(self, params) -> TrainState:
        """A fresh state (step 0, zero moments) around a copy of
        ``params`` on the trainer's device (for example a JAX param tree
        through :func:`ray_tpu_torch.interop.params_from_numpy`); on a
        mesh the full params, rank 0's, are distributed."""
        return self._fresh_state(self._place(_unflatten(
            params, [p.detach().to(self.device, copy=True)
                     for p in _leaves(params)])))

    def init_state(self, seed: int = 0) -> TrainState:
        """Params drawn from a generator seeded with ``seed``. On a mesh
        every rank draws the full params and keeps its shards (a sharded
        init is later work)."""
        return self._init(seed)

    def _init_state(self, seed: int) -> TrainState:
        gen = torch.Generator(device=self.device).manual_seed(seed)
        return self._fresh_state(self._place(
            llama.init_params(self.config, gen, device=self.device),
            src_data_rank=None))

    def _place(self, params, src_data_rank=0):
        """Full params distributed onto the mesh by their placements
        (``src_data_rank=None``: each rank keeps its shard of its own
        copy, the same on every rank); off a mesh, as they are."""
        if self.param_placements is None:
            return params
        return shd.tree_map(
            lambda t, pl: distribute_tensor(t, self.mesh, pl,
                                            src_data_rank=src_data_rank),
            params, self.param_placements)

    def _fresh_state(self, params) -> TrainState:
        """The state owns ``params``: steps update them in place. The
        moments take the params' placements."""
        for p in _leaves(params):
            p.requires_grad_(True)
        return TrainState(step=0, params=params,
                          opt_state=self.optimizer.init(params))

    # -- gradients ---------------------------------------------------------
    def _grads_direct(self, params, batch):
        leaves = _leaves(params)
        loss, metrics = llama.loss_fn(params, batch, self.config, self.mesh)
        grads = torch.autograd.grad(loss, leaves)
        return (_plain(loss.detach()),
                {k: _plain(v.detach()) for k, v in metrics.items()},
                [_placed_like(g, p) for g, p in zip(grads, leaves)])

    def _grads_microbatched(self, params, batch):
        """Token-weighted accumulation over M microbatches: each
        microbatch's mean loss is scaled by tokens_i / total, so the
        summed grads are the single-batch grads up to fp32 reduction
        order, whatever the per-microbatch mask imbalance."""
        M = self.microbatches
        # On a mesh microbatch i holds the global rows [i g/M, (i+1) g/M)
        # split over the batch axes, as JAX's reshape to [M, g/M] does;
        # each rank's own rows cut into M would be other microbatches.
        batch = {k: _plain(v) for k, v in batch.items()}
        tokens = batch["tokens"]
        g = tokens.shape[0]
        if g % M:
            raise ValueError(
                f"global batch {g} not divisible by microbatches={M}")
        mask = batch.get("mask")
        m_full = (mask[:, 1:] if mask is not None
                  else torch.ones_like(tokens[:, 1:])).float()
        total = torch.clamp(m_full.sum(), min=1.0)
        leaves = _leaves(params)
        gsum = [torch.zeros_like(p, dtype=self.grad_accum_dtype)
                for p in leaves]
        loss_sum = torch.zeros((), device=tokens.device)
        correct_sum = torch.zeros((), device=tokens.device)
        micro = g // M
        for i in range(M):
            mb = {k: self._shard_rows(v[i * micro:(i + 1) * micro],
                                      src_data_rank=None)
                  for k, v in batch.items()}
            loss, metrics = llama.loss_fn(params, mb, self.config, self.mesh)
            scaled = loss * (metrics["tokens"] / self._replicated(total))
            grads = torch.autograd.grad(scaled, leaves)
            for acc, gi, p in zip(gsum, grads, leaves):
                acc.add_(_placed_like(gi, p).to(acc.dtype))
            loss_sum = loss_sum + _plain(scaled.detach())
            correct_sum = correct_sum + _plain(
                (metrics["accuracy"] * metrics["tokens"]).detach())
        grads = [acc.to(p.dtype) for acc, p in zip(gsum, leaves)]
        metrics = {"loss": loss_sum, "accuracy": correct_sum / total,
                   "tokens": total}
        return loss_sum, metrics, grads

    def grads(self, params, batch):
        """(loss, metrics, grads in the params' leaf order) of one batch,
        through the microbatched path when ``microbatches > 1``."""
        if self.microbatches == 1:
            return self._grads_direct(params, batch)
        return self._grads_microbatched(params, batch)

    # -- public API --------------------------------------------------------
    def train_step(self, state: TrainState, batch: Dict[str, torch.Tensor]
                   ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        """One optimizer step. The state is donated: its params and
        moments are updated in place and returned in a new TrainState.
        The step runs under :func:`llama.fp32_reduction` (bf16 GEMMs
        reduce in fp32)."""
        return self._step(state, batch)

    def _train_step(self, state: TrainState, batch):
        g = batch["tokens"].shape[0]
        if g % self.microbatches:
            raise ValueError(
                f"global batch {g} not divisible by "
                f"microbatches={self.microbatches}")
        batch = self.shard_batch(batch)
        with llama.fp32_reduction(self.device, self.config.dtype):
            _, metrics, grads = self.grads(state.params, batch)
            metrics["grad_norm"] = AdamW.global_norm(grads)
            opt_state = self.optimizer.apply_(grads, state.opt_state,
                                              state.params,
                                              g_norm=metrics["grad_norm"])
        return TrainState(step=state.step + 1, params=state.params,
                          opt_state=opt_state), metrics

    def shard_batch(self, batch):
        """The batch on the trainer's device; on a mesh its rows split
        over (data, fsdp) (replicated where those axes do not divide the
        batch). DTensors are left as they are."""
        return {k: v if isinstance(v, DTensor)
                else self._shard_rows(v.to(self.device))
                for k, v in batch.items()}

    def _shard_rows(self, x, src_data_rank=0):
        if not llama.on_mesh(self.mesh):
            return x
        spec = _divisible_spec(BATCH_SPEC, x.shape, self.mesh)
        return distribute_tensor(x, self.mesh,
                                 shd.spec_placements(spec, self.mesh),
                                 src_data_rank=src_data_rank)

    def _replicated(self, t):
        """A plain tensor, the same on every rank, as a replicated
        DTensor on the mesh (itself off a mesh)."""
        if not llama.on_mesh(self.mesh):
            return t
        return DTensor.from_local(t, self.mesh,
                                  [Replicate()] * self.mesh.ndim,
                                  run_check=False)

    # -- checkpoint plane hooks --------------------------------------------
    def save_state(self, plane, state: TrainState, step=None):
        """Async-save ``state`` through a checkpoint plane
        (:class:`ray_tpu_torch.checkpoint.CheckpointPlane`). The
        device-to-host copy is complete before this returns (the next
        step updates the state in place); serialization, write and
        manifest commit run in the background. Returns the SaveHandle."""
        return plane.save_async(int(state.step if step is None else step),
                                state)

    def restore_state(self, plane, step=None) -> TrainState:
        """Restore a committed checkpoint onto THIS trainer's layout.

        The saving layout is irrelevant: each leaf is assembled whole and
        distributed by this trainer's placements (save on fsdp=4, restore
        on fsdp=2 x tensor=2 or on one device, bit for bit). A step the
        JAX package's ``ShardedTrainer.save_state`` wrote reads by its
        ``TrainState``'s leaf order."""
        from ray_tpu_torch.checkpoint import plane as ckpt

        shapes = llama.param_shapes(self.config)
        order = ckpt.key_paths(shapes)

        def place(path, t):
            """A param or moment onto the trainer's device and layout
            (each rank holds the full tensor: it keeps its shard)."""
            if path[0] == "params":
                where = path[1:]
            elif path[:2] in (("opt_state", "mu"), ("opt_state", "nu")):
                where = path[2:]
            else:
                return t
            t = t.to(self.device)
            if self.param_placements is None:
                return t
            return distribute_tensor(
                t, self.mesh, ckpt.at_path(self.param_placements, where),
                src_data_rank=None)

        got = plane.restore(place, step=step,
                            paths=ckpt.train_state_paths(order))
        saved = ckpt.sorted_key_paths(got.params)
        if sorted(saved) != sorted(order):
            raise ValueError(f"checkpoint params {saved} are not this "
                             f"trainer's {order}")
        mu = dict(zip(saved, got.opt_state.mu))
        nu = dict(zip(saved, got.opt_state.nu))
        params = _unflatten(shapes, [ckpt.at_path(got.params, p).requires_grad_(
            True) for p in order])
        return TrainState(step=got.step, params=params, opt_state=OptState(
            count=got.opt_state.count, mu=[mu[p] for p in order],
            nu=[nu[p] for p in order]))


def _placed_like(g, p):
    """Grad ``g`` in param ``p``'s placements: the reduce-scatter or
    all-reduce of a partial sum (a plain grad is returned as it is)."""
    if not isinstance(p, DTensor) or tuple(g.placements) == tuple(
            p.placements):
        return g
    return g.redistribute(p.device_mesh, p.placements)


def synthetic_batch(batch_size: int, seq_len: int, vocab_size: int,
                    seed: int = 0, device=None) -> Dict[str, torch.Tensor]:
    """Uniform random int32 tokens from a CPU ``torch.Generator`` seeded
    with ``seed`` (the same tokens on every device), all-ones mask."""
    gen = torch.Generator().manual_seed(seed)
    tokens = torch.randint(0, vocab_size, (batch_size, seq_len),
                           generator=gen, dtype=torch.int32)
    device = llama.default_device(device)
    tokens = tokens.to(device)
    return {"tokens": tokens, "mask": torch.ones_like(tokens)}

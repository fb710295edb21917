"""One-device train step for the Llama family (port of
``ray_tpu/models/training.py``).

:class:`ShardedTrainer` keeps the JAX trainer's interface on one device:
``init_state``, ``train_step`` with token-weighted gradient accumulation
over microbatches, and ``metrics["grad_norm"]``. Sharding over a mesh
(the logical-axis ``rules``, ``shard_batch``) waits for ROADMAP.md queue
A, item 7, and the checkpoint plane hooks for item 8; they raise.

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

from ray_tpu_torch.models import llama


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
        """sqrt of the sum of squares over every leaf, in fp32."""
        return torch.sqrt(sum(g.float().square().sum()
                              for g in _leaves(grads)))

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
        """``update`` and ``apply_updates`` in place, one leaf at a time:
        params, mu and nu are overwritten, so no leaf's temporaries
        outlive it. ``g_norm``: the grads' global norm, when the caller
        has it."""
        g_norm, clip, count_inc, step_size = self._begin(grads, state,
                                                         g_norm)
        for g, mu, nu, p in zip(_leaves(grads), state.mu, state.nu,
                                _leaves(params)):
            u, mu_new, nu_new = self._leaf(g, mu, nu, p, g_norm, clip,
                                           count_inc, step_size)
            p.copy_((p + u).to(p.dtype))
            mu.copy_(mu_new)
            nu.copy_(nu_new)
        state.count = count_inc
        return state


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


_CHECKPOINT = "item 8 (ray_tpu_torch/train and ray_tpu_torch/checkpoint)"


class ShardedTrainer:
    """The JAX trainer's train step on one device.

    ``device`` defaults to ``cuda`` (raises without a GPU; pass
    ``device="cpu"`` for the plain path). ``mesh`` may be None or a
    one-device mapping of axis sizes; a larger mesh, or ``rules``,
    raises until sharding is ported.
    """

    def __init__(self, config: llama.LlamaConfig, mesh=None,
                 optimizer: Optional[AdamW] = None, rules=None,
                 microbatches: int = 1, grad_accum_dtype: Any = None,
                 device=None):
        if rules is not None:
            raise llama.not_ported("logical-axis sharding rules",
                                   llama.SHARDING_ITEM)
        if math.prod(llama.mesh_shape(mesh).values()) > 1:
            raise llama.not_ported("a mesh of more than one device",
                                   llama.SHARDING_ITEM)
        self.config = config
        self.mesh = mesh
        self.device = llama.default_device(device)
        self.optimizer = optimizer or default_optimizer()
        # Token-weighted accumulation over M microbatches, one optimizer
        # update; the accumulator is fp32 unless asked otherwise.
        self.microbatches = max(int(microbatches), 1)
        self.grad_accum_dtype = grad_accum_dtype or torch.float32

    # -- state -------------------------------------------------------------
    def state_from_params(self, params) -> TrainState:
        """A fresh state (step 0, zero moments) around a copy of
        ``params`` on the trainer's device (for example a JAX param tree
        through :func:`ray_tpu_torch.interop.params_from_numpy`)."""
        return self._fresh_state(_unflatten(
            params, [p.detach().to(self.device, copy=True)
                     for p in _leaves(params)]))

    def init_state(self, seed: int = 0) -> TrainState:
        gen = torch.Generator(device=self.device).manual_seed(seed)
        return self._fresh_state(
            llama.init_params(self.config, gen, device=self.device))

    def _fresh_state(self, params) -> TrainState:
        """The state owns ``params``: steps update them in place."""
        for p in _leaves(params):
            p.requires_grad_(True)
        return TrainState(step=0, params=params,
                          opt_state=self.optimizer.init(params))

    # -- gradients ---------------------------------------------------------
    def _grads_direct(self, params, batch):
        loss, metrics = llama.loss_fn(params, batch, self.config, self.mesh)
        grads = torch.autograd.grad(loss, _leaves(params))
        return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
                list(grads))

    def _grads_microbatched(self, params, batch):
        """Token-weighted accumulation over M microbatches: each
        microbatch's mean loss is scaled by tokens_i / total, so the
        summed grads are the single-batch grads up to fp32 reduction
        order, whatever the per-microbatch mask imbalance."""
        M = self.microbatches
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
            mb = {k: v[i * micro:(i + 1) * micro] for k, v in batch.items()}
            loss, metrics = llama.loss_fn(params, mb, self.config, self.mesh)
            scaled = loss * (metrics["tokens"] / total)
            grads = torch.autograd.grad(scaled, leaves)
            for acc, gi in zip(gsum, grads):
                acc.add_(gi.to(acc.dtype))
            loss_sum = loss_sum + scaled.detach()
            correct_sum = correct_sum + (metrics["accuracy"]
                                         * metrics["tokens"]).detach()
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
        g = batch["tokens"].shape[0]
        if g % self.microbatches:
            raise ValueError(
                f"global batch {g} not divisible by "
                f"microbatches={self.microbatches}")
        batch = {k: v.to(self.device) for k, v in batch.items()}
        with llama.fp32_reduction(self.device, self.config.dtype):
            _, metrics, grads = self.grads(state.params, batch)
            metrics["grad_norm"] = AdamW.global_norm(grads)
            opt_state = self.optimizer.apply_(grads, state.opt_state,
                                              state.params,
                                              g_norm=metrics["grad_norm"])
        return TrainState(step=state.step + 1, params=state.params,
                          opt_state=opt_state), metrics

    def shard_batch(self, batch):
        raise llama.not_ported("shard_batch (batch sharding over a mesh)",
                               llama.SHARDING_ITEM)

    # -- checkpoint plane hooks --------------------------------------------
    def save_state(self, plane, state: TrainState, step=None):
        raise llama.not_ported("save_state (the checkpoint plane)",
                               _CHECKPOINT)

    def restore_state(self, plane, step=None):
        raise llama.not_ported("restore_state (the checkpoint plane)",
                               _CHECKPOINT)


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

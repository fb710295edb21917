"""RL experience path: engine logprobs into LearnerGroup-shaped batches
(the port of ``ray_tpu/rl/experience.py``).

Per-token behavior logprobs come from the serving engine itself
(``ContinuousBatcher.score_logprobs``: the same params and forward that
generated the tokens), so the learner's importance ratios are against the
TRUE behavior policy, tagged with the weight version that produced each
sequence. :class:`ExperienceBuffer` packs sequences into the ``[T, N]``
trajectory dicts ``LearnerGroup._shard`` slices (env axis 1; every array
``[T, N]`` or ``[1, N]``), array for array JAX's layout.

:class:`TokenPPOLearner` closes the loop: a token-level PPO update over
a Llama policy with the ``compute_gradients`` / ``apply_gradients`` /
``get_weights`` / ``set_weights`` quartet, so it drops into
``_LearnerActor`` and the LearnerGroup's bucketed allreduce. It runs on
the card (the flash kernels carry its forward and backward) unless
asked for the CPU.
"""

from __future__ import annotations

import time
from typing import Any, Dict, List, NamedTuple, Optional

import numpy as np
import torch

from ray_tpu_torch._private import cuda_monitor


class SequenceRecord(NamedTuple):
    """One generated sequence with everything the learner needs."""

    prompt: List[int]
    tokens: List[int]          # generated tokens
    logprobs: np.ndarray       # behavior per-token logprobs, len(tokens)
    reward: float              # terminal scalar reward
    weight_version: int        # generator version that produced it
    staleness: int             # trainer_version - weight_version at collect


class ExperienceBuffer:
    """Accumulates :class:`SequenceRecord`\\ s and packs them into the
    ``[T, N]`` trajectory-dict layout (sequences along axis 1, token
    positions along axis 0, right-padded with a mask)."""

    def __init__(self, gamma: float = 1.0):
        self.gamma = float(gamma)
        self._records: List[SequenceRecord] = []

    def add(self, record: SequenceRecord) -> None:
        self._records.append(record)

    def __len__(self) -> int:
        return len(self._records)

    def staleness(self) -> List[int]:
        return [r.staleness for r in self._records]

    def clear(self) -> None:
        self._records = []

    def to_batch(self, max_len: Optional[int] = None
                 ) -> Dict[str, np.ndarray]:
        """Pack to one trajectory dict. Shapes: ``tokens_full`` [S, N]
        (prompt + generation, right-padded), ``actions`` /
        ``behavior_logp`` / ``advantages`` / ``mask`` [T, N] over the
        generated positions, ``prompt_len`` / ``weight_version`` /
        ``staleness`` [1, N] (2-D so the shard slice ``v[:, lo:hi]``
        applies uniformly). Advantages are the reward broadcast over the
        sequence's tokens, whitened across the batch."""
        recs = self._records
        if not recs:
            raise ValueError("experience buffer is empty")
        N = len(recs)
        T = max(len(r.tokens) for r in recs)
        S = max(len(r.prompt) + len(r.tokens) for r in recs)
        if max_len is not None:
            S = max(S, int(max_len))
        tokens_full = np.zeros((S, N), np.int32)
        actions = np.zeros((T, N), np.int32)
        behavior_logp = np.zeros((T, N), np.float32)
        mask = np.zeros((T, N), np.float32)
        rewards = np.zeros((N,), np.float32)
        prompt_len = np.zeros((1, N), np.int32)
        version = np.zeros((1, N), np.int32)
        staleness = np.zeros((1, N), np.int32)
        for n, r in enumerate(recs):
            full = list(r.prompt) + list(r.tokens)
            tokens_full[:len(full), n] = full
            t = len(r.tokens)
            actions[:t, n] = r.tokens
            behavior_logp[:t, n] = np.asarray(r.logprobs, np.float32)
            mask[:t, n] = 1.0
            rewards[n] = r.reward
            prompt_len[0, n] = len(r.prompt)
            version[0, n] = r.weight_version
            staleness[0, n] = r.staleness
        adv = rewards - rewards.mean()
        std = rewards.std()
        if std > 1e-6:
            adv = adv / std
        advantages = (adv[None, :] * mask).astype(np.float32)
        return {
            "tokens_full": tokens_full,
            "actions": actions,
            "behavior_logp": behavior_logp,
            "advantages": advantages,
            "mask": mask,
            "prompt_len": prompt_len,
            "weight_version": version,
            "staleness": staleness,
        }


def _adam(lr: float):
    """``optax.adam(lr)`` as the port's AdamW: b1 0.9, b2 0.999, eps
    1e-8, bias correction by the incremented count, moments in the
    params' dtype, no weight decay, no clipping, a constant rate."""
    from ray_tpu_torch.models.training import AdamW

    class Adam(AdamW):
        def schedule(self, count: int) -> np.float32:
            return np.float32(self.learning_rate)

        def _begin(self, grads, state, g_norm=None):
            return None, False, state.count + 1, -self.schedule(state.count)

    return Adam(lr, 0.0, 0.9, 0.999, float("inf"), 0, 1)


def _host(tree):
    """A dict tree of tensors as host tensors."""
    if isinstance(tree, dict):
        return {k: _host(v) for k, v in tree.items()}
    return tree.detach().to("cpu", copy=True)


class TokenPPOLearner:
    """Token-level PPO over a Llama policy (the generator's own weights).

    The clipped surrogate runs per generated token against the engine's
    behavior logprobs; ``rho_clip`` additionally caps the importance
    ratio IMPALA/APPO-style, bounding the correction applied to stale
    (off-policy) sequences collected under an older weight version.

    ``device``: None means ``cuda`` (raises with no card); ``params``
    None draws the model from ``seed`` on the device, as the deployment's
    cold start does. The update runs under ``llama.fp32_reduction``, as
    the trainer's step.
    """

    def __init__(self, config: Any, params: Any = None, lr: float = 1e-3,
                 clip: float = 0.2, rho_clip: Optional[float] = None,
                 entropy_coeff: float = 0.0, seed: int = 0, device=None):
        from ray_tpu_torch.models import llama
        from ray_tpu_torch.models.training import _leaves, _unflatten

        self.config = config
        self.device = llama.default_device(device)
        self.optimizer = _adam(lr)
        if params is None:
            gen = torch.Generator(device=self.device).manual_seed(seed)
            params = llama.init_params(config, gen, device=self.device)
        else:
            params = _unflatten(params, [
                (torch.from_numpy(np.array(p)) if isinstance(p, np.ndarray)
                 else p).detach().to(self.device, copy=True)
                for p in _leaves(params)])
        for p in _leaves(params):
            p.requires_grad_(True)
        self.params = params
        self.opt_state = self.optimizer.init(self.params)
        clip_c, rho_c, ent_c = clip, rho_clip, entropy_coeff
        cfg, dev = config, self.device

        def loss_fn(params, b):
            # Teacher-forced forward over the full padded sequences: the
            # hidden state at position s predicts the token at s+1, so
            # generated token t of sequence n is scored by the row at
            # prompt_len[n] - 1 + t. Only those rows go through the head
            # (JAX takes them from the whole [N, S, V] log-softmax: the
            # same values). A row past the sequence (a shorter
            # generation's masked tail) reads the last position.
            tokens = b["tokens_full"].t()
            x, _ = llama.hidden_states(params, tokens, cfg)
            T = b["actions"].shape[0]
            pos = (b["prompt_len"][0][:, None] - 1
                   + torch.arange(T, device=dev)[None, :])      # [N, T]
            pos = pos.clamp(0, tokens.shape[1] - 1)
            xs = torch.gather(x, 1, pos[..., None].expand(
                -1, -1, x.shape[-1]))                            # [N, T, E]
            logits = llama.head_logits(xs, params["lm_head"].to(cfg.dtype))
            rows = torch.log_softmax(logits, dim=-1)             # [N, T, V]
            logp = rows.gather(2, b["actions"].t()[..., None])[..., 0].t()
            ratio = torch.exp(logp - b["behavior_logp"])
            if rho_c is not None:
                # Off-policy staleness correction: V-trace-style rho cap
                # on top of PPO's two-sided clip.
                ratio = torch.clamp(ratio, max=rho_c)
            adv = b["advantages"]
            surr = torch.minimum(
                ratio * adv,
                torch.clamp(ratio, 1.0 - clip_c, 1.0 + clip_c) * adv)
            mask = b["mask"]
            denom = torch.clamp(mask.sum(), min=1.0)
            pg_loss = -(surr * mask).sum() / denom
            entropy = -((torch.exp(rows) * rows).sum(-1).t()
                        * mask).sum() / denom
            total = pg_loss - ent_c * entropy
            return total, {"policy_loss": pg_loss, "entropy": entropy,
                           "mean_ratio": (ratio * mask).sum() / denom}

        def grad_fn(params, b):
            leaves = _leaves(params)
            with llama.fp32_reduction(dev, cfg.dtype):
                loss, metrics = loss_fn(params, b)
                grads = torch.autograd.grad(loss, leaves)
            return (loss.detach(), {k: v.detach()
                                    for k, v in metrics.items()}), \
                _unflatten(params, list(grads))

        def apply_fn(params, opt_state, grads):
            return self.optimizer.apply_(_leaves(grads), opt_state,
                                         params)

        self._grad_fn = cuda_monitor.instrument(grad_fn, name="rl_ppo_grad",
                                                device=dev)
        self._apply_fn = cuda_monitor.instrument(apply_fn,
                                                 name="rl_ppo_apply",
                                                 device=dev)

    def _to_device(self, batch: Dict[str, np.ndarray]) -> Dict[str, Any]:
        out = {}
        for k, v in batch.items():
            if k in ("weight_version", "staleness"):
                continue
            t = torch.as_tensor(np.asarray(v))
            if k in ("tokens_full", "actions", "prompt_len"):
                t = t.long()
            out[k] = t.to(self.device)
        return out

    def compute_gradients(self, batch: Dict[str, np.ndarray]):
        """(grads, metrics) of one batch. The metrics' fetch syncs the
        card, so the wall time from the dispatch to it is the step's:
        it feeds ``rl_ppo_grad``'s achieved FLOP/s and MFU gauges (JAX's
        learner leaves them to call cadence, which in an RL loop spans a
        whole round)."""
        batch = self._to_device(batch)
        t0 = time.perf_counter()
        (loss, metrics), grads = self._grad_fn(self.params, batch)
        metrics = {k: float(v) for k, v in metrics.items()}
        metrics["total_loss"] = float(loss)
        self._grad_fn.note_execution(time.perf_counter() - t0)
        return grads, metrics

    def apply_gradients(self, grads) -> None:
        """One Adam step on ``grads`` (a tree of tensors of the params'
        nesting, matched by key), in place."""
        def on_device(ref, g):
            if isinstance(ref, dict):
                return {k: on_device(v, g[k]) for k, v in ref.items()}
            return g.to(self.device, ref.dtype)

        self.opt_state = self._apply_fn(self.params, self.opt_state,
                                        on_device(self.params, grads))

    def update_from_batch(self, batch) -> Dict[str, float]:
        grads, metrics = self.compute_gradients(batch)
        self.apply_gradients(grads)
        return metrics

    def get_weights(self):
        """The params as a host tree of tensors (JAX: numpy)."""
        return _host(self.params)

    def set_weights(self, weights) -> None:
        """Copy ``weights`` (a host or device tree, tensors or numpy, of
        the params' nesting) into the params, leaf by key."""
        def copy(dst, src):
            if isinstance(dst, dict):
                for k, v in dst.items():
                    copy(v, src[k])
                return
            dst.copy_(torch.from_numpy(np.array(src))
                      if isinstance(src, np.ndarray) else src)

        with torch.no_grad():
            copy(self.params, weights)


__all__ = ["SequenceRecord", "ExperienceBuffer", "TokenPPOLearner"]

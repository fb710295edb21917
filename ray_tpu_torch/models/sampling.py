"""Token sampling for the decode data plane (port of
``ray_tpu/models/sampling.py``).

Greedy is argmax. Temperature/top-p sampling draws from
:func:`filtered_probs` with a ``torch.Generator`` derived from
(seed, salt, step) by :func:`step_key`, so a fixed seed replays exactly.
The draws are not JAX's (Philox or the CPU generator against threefry):
what carries across is the distribution, not the bits.
:func:`spec_commit` is speculative decode's per-slot acceptance.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass
from typing import Optional

import torch


@dataclass(frozen=True)
class SamplingParams:
    """Engine-level sampling configuration.

    ``temperature <= 0`` means greedy argmax (the default). ``top_p``
    keeps the smallest prefix of the sorted distribution whose
    cumulative probability covers ``top_p`` (the first token always
    survives)."""

    temperature: float = 0.0
    top_p: float = 1.0
    seed: int = 0

    def __post_init__(self):
        # top_p <= 0 would mask every logit and stream token 0 forever.
        if not 0.0 < self.top_p <= 1.0:
            raise ValueError(f"top_p must be in (0, 1], got {self.top_p}")
        if not self.temperature >= 0.0:
            raise ValueError(
                f"temperature must be >= 0, got {self.temperature}")

    @property
    def greedy(self) -> bool:
        return self.temperature <= 0.0

    @classmethod
    def coerce(cls, value) -> "SamplingParams":
        """Accept SamplingParams | dict | None."""
        if value is None:
            return cls()
        if isinstance(value, cls):
            return value
        if isinstance(value, dict):
            return cls(**value)
        raise TypeError(f"sampling must be SamplingParams or dict, "
                        f"got {type(value)}")


def filtered_probs(logits, temperature: float, top_p: float):
    """The exact post-temperature/top-p distribution
    :func:`sample_tokens` draws from, as probability rows: softmax over
    the filtered scaled logits (exclusive-cumsum keep, boundary ties
    kept). [..., V] -> [..., V]."""
    scaled = logits / temperature
    if top_p < 1.0:
        sorted_desc = torch.sort(scaled, dim=-1, descending=True).values
        probs = torch.softmax(sorted_desc, dim=-1)
        cum = torch.cumsum(probs, dim=-1)
        keep = (cum - probs) < top_p
        inf = torch.tensor(float("inf"), device=logits.device)
        cutoff = torch.where(keep, sorted_desc, inf).amin(dim=-1,
                                                          keepdim=True)
        scaled = torch.where(scaled >= cutoff, scaled, -inf)
    return torch.softmax(scaled, dim=-1)


def sample_tokens(logits, generator, temperature: float, top_p: float):
    """logits [B, V] fp32 -> token ids [B] int32: argmax when
    ``temperature <= 0``, else one draw per row from
    :func:`filtered_probs` with ``generator``."""
    if temperature <= 0.0:
        return logits.argmax(dim=-1).to(torch.int32)
    probs = filtered_probs(logits.float(), temperature, top_p)
    return torch.multinomial(probs, 1, generator=generator)[:, 0].to(
        torch.int32)


def step_key(seed: int, step: int, salt: int = 0, device=None, *,
             index: Optional[int] = None) -> torch.Generator:
    """Deterministic per-step generator on ``device``, seeded from
    (seed, salt, step); the salt separates the tick, prefill and
    speculative streams. ``index`` splits a step's stream further (the
    draft position of a spec tick, JAX's ``fold_in(key, i)``)."""
    tag = f"{seed}:{salt}:{step}" + ("" if index is None else f":{index}")
    digest = hashlib.blake2b(tag.encode(), digest_size=8).digest()
    gen = torch.Generator(device=device if device is not None else "cpu")
    gen.manual_seed(int.from_bytes(digest, "little") & ((1 << 63) - 1))
    return gen


# Speculative-decode streams. Salt 0 is the plain decode tick and 1 the
# prefill sampler; spec ticks never draw from salt 0, so an engine whose
# adaptive k falls to 0 re-enters the plain tick's exact sample sequence.
SPEC_DRAFT_SALT = 2    # the drafter's proposals (index = draft position)
SPEC_ACCEPT_SALT = 3   # accept/reject uniforms
SPEC_FIX_SALT = 4      # residual resamples and the bonus token


def spec_commit(draft_tokens, draft_probs, logits, step: int,
                sampling: SamplingParams):
    """Per-slot speculative acceptance, on the logits' device.

    ``draft_tokens`` [B, k] int32: the drafter's proposals d_1..d_k;
    ``draft_probs`` [B, k, V]: the filtered rows each d_i was drawn from
    (None under greedy); ``logits`` [B, k+1, V] fp32: the target's logits
    at the k+1 verified positions (row i conditions on the committed
    prefix plus d_1..d_i).

    Returns ``(committed [B, k+1] int32, counts [B] int32)``, counts in
    [1, k+1]: each slot commits its accepted draft prefix plus one token
    of the target's own (the correction at the first mismatch, or the
    bonus when every draft survived). Entries past a slot's count mean
    nothing.

    Greedy: accept while d_i == argmax_i, so the committed stream is the
    target's own greedy stream. Sampled (Leviathan et al. 2023): accept
    d_i with probability min(1, p_i(d_i) / q_i(d_i)), uniforms from the
    generator of (seed, SPEC_ACCEPT_SALT, step); at the first rejection
    draw from the residual max(p_i - q_i, 0) renormalised (``p_i`` where
    it sums to 0); a fully accepted window draws the bonus from p_{k+1};
    both draws from the generator of (seed, SPEC_FIX_SALT, step). Every
    committed token is then distributed as the target's sampler, and a
    replayed step (a buffered rewind) commits the same tokens."""
    b, k1, vocab = logits.shape
    k = k1 - 1
    dev = logits.device
    if sampling.greedy:
        target = logits.argmax(dim=-1).to(torch.int32)
        if k == 0:
            return target, torch.ones((b,), dtype=torch.int32, device=dev)
        match = (draft_tokens == target[:, :k]).to(torch.int32)
        accepts = torch.cumprod(match, dim=1).sum(dim=1)
        return target, (accepts + 1).to(torch.int32)

    p = filtered_probs(logits.float(), sampling.temperature, sampling.top_p)
    p_d = p[:, :k]                                           # [B, k, V]
    idx = draft_tokens.long()[..., None]
    p_at = torch.gather(p_d, -1, idx)[..., 0]                # [B, k]
    q_at = torch.gather(draft_probs, -1, idx)[..., 0]
    u = torch.rand((b, k), device=dev, generator=step_key(
        sampling.seed, step, SPEC_ACCEPT_SALT, device=dev))
    ratio = p_at / q_at.clamp_min(1e-30)
    acc = (u < ratio.clamp(max=1.0)).to(torch.int32)
    accepts = torch.cumprod(acc, dim=1).sum(dim=1)           # [B]
    resid = (p_d - draft_probs).clamp_min(0.0)
    total = resid.sum(dim=-1, keepdim=True)
    resid = torch.where(total > 0, resid / total.clamp_min(1e-30), p_d)
    fix_dist = torch.cat([resid, p[:, k:]], dim=1)           # [B, k+1, V]
    fix = torch.multinomial(
        fix_dist.reshape(b * k1, vocab), 1,
        generator=step_key(sampling.seed, step, SPEC_FIX_SALT, device=dev))
    fix = fix.reshape(b, k1).to(torch.int32)
    pos = torch.arange(k1, device=dev)[None, :]
    padded = torch.nn.functional.pad(draft_tokens.to(torch.int32), (0, 1))
    committed = torch.where(pos < accepts[:, None], padded, fix)
    return committed, (accepts + 1).to(torch.int32)

"""Token sampling for the decode data plane (port of
``ray_tpu/models/sampling.py``).

Greedy is argmax. Temperature/top-p sampling draws from
:func:`filtered_probs` with a ``torch.Generator`` derived from
(seed, salt, step) by :func:`step_key`, so a fixed seed replays exactly.
The draws are not JAX's (Philox or the CPU generator against threefry):
what carries across is the distribution, not the bits.
``spec_commit`` comes with the speculative-decode slice.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass

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


def step_key(seed: int, step: int, salt: int = 0,
             device=None) -> torch.Generator:
    """Deterministic per-step generator on ``device``, seeded from
    (seed, salt, step); the salt separates the tick and prefill
    streams."""
    digest = hashlib.blake2b(f"{seed}:{salt}:{step}".encode(),
                             digest_size=8).digest()
    gen = torch.Generator(device=device if device is not None else "cpu")
    gen.manual_seed(int.from_bytes(digest, "little") & ((1 << 63) - 1))
    return gen

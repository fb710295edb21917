"""RL rollout scheduler: generation and learner steps in turns (the port
of ``ray_tpu/rl/rollout.py``).

Generation and the learner update alternate as *phases*. Every generated
sequence is tagged with the weight version the generator replica held
when it produced it. Staleness (trainer version minus sequence version)
is first-class: the ``ray_tpu_rl_rollout_staleness`` gauge tracks it
live, and ``staleness_clip`` drops sequences beyond the clip from the
batch (the learner additionally rho-clips what remains, the IMPALA/APPO
off-policy correction).

On a shared card pool each learner phase rides a short-deadline
arbiter lease (``ChipPoolArbiter.request_handoff`` serve to train,
``lease_s`` the phase deadline, :mod:`ray_tpu_torch.autoscaler.arbiter`),
so the cards flow back to serving once the update lands. Without an
arbiter the phases still alternate; only the lease is skipped.
"""

from __future__ import annotations

import logging
import time
from typing import Any, Callable, Dict, List, Optional, Sequence

from ray_tpu_torch.rl.experience import ExperienceBuffer, SequenceRecord

logger = logging.getLogger(__name__)


class RolloutScheduler:
    """Drives generate -> score -> train rounds against a live generator.

    ``generate_fn(prompt_tokens, max_new_tokens) -> (tokens, logprobs,
    weight_version)`` is the generation hop, typically a closure over a
    serve handle or a local engine. ``trainer_version_fn`` reports the
    trainer's current published version (the staleness reference).
    """

    def __init__(self, generate_fn: Callable,
                 trainer_version_fn: Callable[[], int],
                 run: str = "rl",
                 staleness_clip: Optional[int] = None,
                 arbiter: Any = None,
                 learner_chips: int = 1,
                 lease_s: float = 5.0,
                 gamma: float = 1.0):
        self.generate = generate_fn
        self.trainer_version = trainer_version_fn
        self.run = run
        self.staleness_clip = staleness_clip
        self.arbiter = arbiter
        self.learner_chips = max(int(learner_chips), 1)
        self.lease_s = float(lease_s)
        self.buffer = ExperienceBuffer(gamma=gamma)
        self.dropped_stale = 0
        self._mtags = {"run": run}

    # -------------------------------------------------- generation phase
    def collect(self, prompts: Sequence[Sequence[int]],
                max_new_tokens: int,
                reward_fn: Callable[[List[int], List[int]], float],
                cause: str = "") -> int:
        """One generation phase: batch ``prompts`` through the engine,
        score each completed sequence with ``reward_fn(prompt, tokens)``,
        tag with version and staleness, and admit to the buffer. Returns
        the number of sequences admitted (stale-clipped ones are counted
        in ``dropped_stale``, not admitted)."""
        from ray_tpu_torch._private import events as _events
        from ray_tpu_torch._private import metrics_defs as mdefs

        trainer_v = int(self.trainer_version())
        admitted = 0
        worst_staleness = 0
        for prompt in prompts:
            tokens, logprobs, version = self.generate(
                list(prompt), max_new_tokens)
            staleness = max(trainer_v - int(version), 0)
            worst_staleness = max(worst_staleness, staleness)
            if self.staleness_clip is not None \
                    and staleness > self.staleness_clip:
                self.dropped_stale += 1
                _events.emit("rl.rollout_clip", cause=cause,
                             subject={"run": self.run},
                             version=int(version), trainer_version=trainer_v,
                             staleness=staleness)
                continue
            self.buffer.add(SequenceRecord(
                prompt=list(prompt), tokens=list(tokens),
                logprobs=logprobs, reward=float(reward_fn(list(prompt),
                                                          list(tokens))),
                weight_version=int(version), staleness=staleness))
            admitted += 1
        mdefs.RL_ROLLOUT_STALENESS.set(worst_staleness, tags=self._mtags)
        return admitted

    # ----------------------------------------------------- learner phase
    def learner_phase(self, fn: Callable[[], Any], cause: str = "") -> Any:
        """Run one learner step between ``rl.learner_phase`` and
        ``rl.learner_phase_done`` events, under a serve-to-train lease of
        ``learner_chips`` for ``lease_s`` when an arbiter co-schedules
        the pool (the lease's deadline returns the cards). The step runs
        whether or not the lease was granted."""
        from ray_tpu_torch._private import events as _events

        lease_id = ""
        if self.arbiter is not None:
            try:
                lease_id = self.arbiter.request_handoff(
                    "serve", self.learner_chips, lease_s=self.lease_s)
            except Exception:  # noqa: BLE001 — degraded: run unleased
                logger.exception("rl: learner-phase lease failed; "
                                 "running without a handoff")
        event_id = _events.emit(
            "rl.learner_phase", cause=cause,
            subject={"run": self.run, "lease_id": lease_id})
        t0 = time.perf_counter()
        try:
            return fn()
        finally:
            _events.emit("rl.learner_phase_done", cause=event_id,
                         subject={"run": self.run, "lease_id": lease_id},
                         seconds=round(time.perf_counter() - t0, 6))

    def drain_batch(self, max_len: Optional[int] = None
                    ) -> Dict[str, Any]:
        """Pop the accumulated experience as one [T, N] trajectory dict."""
        batch = self.buffer.to_batch(max_len=max_len)
        self.buffer.clear()
        return batch


__all__ = ["RolloutScheduler"]

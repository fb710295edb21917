"""APPO: asynchronous PPO on the IMPALA machinery (the port of
``ray_tpu/rllib/appo.py``).

Reference: ``rllib/algorithms/appo/appo.py``: IMPALA's decoupled
actor/learner architecture (stale behavior policies, V-trace off-policy
correction, continuous in-flight rollouts) with PPO's clipped surrogate
objective in place of the plain V-trace policy gradient: the likelihood
ratio is taken against the BEHAVIOR policy and clipped to
``clip_param``. Everything else is :class:`~ray_tpu_torch.rllib.impala.IMPALA`'s.
"""

from __future__ import annotations

import dataclasses

from ray_tpu_torch.rllib.impala import IMPALA, IMPALAConfig


@dataclasses.dataclass
class APPOConfig(IMPALAConfig):
    clip_param: float = 0.2

    def build(self) -> "APPO":
        return APPO(self)


class APPO(IMPALA):
    @staticmethod
    def _learner_kwargs(cfg):
        return dict(IMPALA._learner_kwargs(cfg), clip_param=cfg.clip_param)


__all__ = ["APPO", "APPOConfig"]

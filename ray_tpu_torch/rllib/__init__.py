"""ray_tpu_torch.rllib: reinforcement learning (the port of
``ray_tpu/rllib``). Ported so far: :class:`LearnerGroup`, which the RL
post-training loop drives; the rest of the package (the runners, PPO,
APPO, IMPALA, DQN, SAC and multi-agent) is ROADMAP item 12."""

from ray_tpu_torch.rllib.learner_group import LearnerGroup

__all__ = ["LearnerGroup"]

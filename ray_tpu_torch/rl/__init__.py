"""ray_tpu_torch.rl: the RL post-training loop, serve <-> train weight
sync (the port of ``ray_tpu/rl``).

Three legs: the weight-sync plane (:mod:`ray_tpu_torch.rl.weight_sync`,
versioned crc32 manifests over a shared-memory channel with a checkpoint
fallback), the rollout scheduler (:mod:`ray_tpu_torch.rl.rollout`,
generation and learner phases in turns, staleness first-class), and the
experience path (:mod:`ray_tpu_torch.rl.experience`, engine logprobs
into LearnerGroup-shaped batches, token-level PPO). The generator side
lives on ``ContinuousLlamaDeployment.swap_weights`` /
``enable_weight_sync`` (tick-boundary swap) and
``ContinuousBatcher.swap_params``.
"""

from ray_tpu_torch.rl.experience import (ExperienceBuffer, SequenceRecord,
                                         TokenPPOLearner)
from ray_tpu_torch.rl.rollout import RolloutScheduler
from ray_tpu_torch.rl.weight_sync import (RL_KV_NS, WeightPublisher,
                                          WeightSubscriber, WeightSyncError,
                                          build_manifest, latest_manifest,
                                          verify_manifest)

__all__ = [
    "ExperienceBuffer", "SequenceRecord", "TokenPPOLearner",
    "RolloutScheduler", "RL_KV_NS", "WeightPublisher", "WeightSubscriber",
    "WeightSyncError", "build_manifest", "latest_manifest",
    "verify_manifest",
]

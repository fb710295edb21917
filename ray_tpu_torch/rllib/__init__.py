"""ray_tpu_torch.rllib: reinforcement learning (the port of
``ray_tpu/rllib``; reference: ``rllib/``). Learners hold their params on
the card unless a config's ``.learners(use_gpu=False)`` asks for the CPU;
env runners are CPU processes of the port's runtime."""

from ray_tpu_torch.rllib.core import (
    DQNLearner,
    DQNModule,
    PPOLearner,
    PPOModule,
    ReplayBuffer,
    SampleBatch,
    Transition,
    compute_gae,
)
from ray_tpu_torch.rllib.core import (ImpalaLearner, SACLearner, SACModule,
                                      vtrace)
from ray_tpu_torch.rllib.dqn import DQN, DQNConfig
from ray_tpu_torch.rllib.env_runner import (
    ContinuousEnvRunner,
    EnvRunnerGroup,
    SingleAgentEnvRunner,
    TrajectoryEnvRunner,
    TransitionEnvRunner,
)
from ray_tpu_torch.rllib.actor_manager import FaultTolerantActorManager
from ray_tpu_torch.rllib.appo import APPO, APPOConfig
from ray_tpu_torch.rllib.impala import IMPALA, IMPALAConfig
from ray_tpu_torch.rllib.learner_group import LearnerGroup
from ray_tpu_torch.rllib.multi_agent import (
    MultiAgentEnv,
    MultiAgentEnvRunner,
    MultiAgentPPO,
    MultiAgentPPOConfig,
)
from ray_tpu_torch.rllib.sac import SAC, SACConfig
from ray_tpu_torch.rllib.ppo import PPO, PPOConfig

__all__ = [
    "ContinuousEnvRunner", "DQN", "DQNConfig", "DQNLearner", "DQNModule",
    "EnvRunnerGroup", "FaultTolerantActorManager", "APPO", "APPOConfig",
    "IMPALA", "IMPALAConfig", "ImpalaLearner", "LearnerGroup",
    "MultiAgentEnv", "MultiAgentEnvRunner", "MultiAgentPPO",
    "MultiAgentPPOConfig", "PPO", "PPOConfig", "PPOLearner", "PPOModule",
    "ReplayBuffer", "SAC", "SACConfig", "SACLearner", "SACModule",
    "SampleBatch", "SingleAgentEnvRunner", "TrajectoryEnvRunner",
    "Transition", "TransitionEnvRunner", "compute_gae", "vtrace",
]

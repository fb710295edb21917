"""Train/AIR configuration dataclasses (port of ``ray_tpu/train/config.py``).

Reference: ``python/ray/air/config.py`` (ScalingConfig/RunConfig/
FailureConfig/CheckpointConfig). Where the JAX package asks TPU chips of
a worker (``use_tpu``, ``tpus_per_worker``, a ``topology`` slice) the
port asks cards: ``use_gpu`` and ``gpus_per_worker``, each worker a
process that sees its cards through ``CUDA_VISIBLE_DEVICES``. ``mesh``
is the port's :class:`~ray_tpu_torch.parallel.MeshConfig`, the layout the
train loop builds over the workers' process group.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

from ray_tpu_torch.parallel.mesh import MeshConfig

# Placement groups for worker groups wait with the serve runtime's
# (``serve/api.py``): the local-mode groups of ``util/placement_group.py``
# do not place processes.
_PLACEMENT_ITEM = "item 17 (the serve leftovers)"


@dataclasses.dataclass
class ScalingConfig:
    """How many workers and what each one owns.

    ``num_workers`` is the number of worker *processes*; with
    ``use_gpu`` each owns ``gpus_per_worker`` cards (default 1) and all
    of them join one ``torch.distributed`` group (NCCL on cards, gloo
    on the CPU) when ``torch_distributed`` is set and there is more than
    one. ``use_gpu`` is on unless the caller asks for CPU processes with
    ``use_gpu=False``; a ``use_gpu`` run on a host with no card raises,
    it never carries on in CPU processes.
    """

    num_workers: int = 1
    # Elastic lower bound (reference: Train v2 elastic training): after a
    # failure the controller restarts with as many workers as the host
    # can currently supply, as long as it's at least this. None = rigid.
    min_workers: Optional[int] = None
    use_gpu: bool = True
    gpus_per_worker: Optional[float] = None
    cpus_per_worker: float = 1.0
    resources_per_worker: Optional[Dict[str, float]] = None
    mesh: Optional[MeshConfig] = None    # parallelism layout over all cards
    placement_strategy: str = "PACK"
    # Form the workers' torch.distributed group (worker 0 hosts the
    # rendezvous). The JAX package's ``jax_distributed``; on by default,
    # since each port worker is a process of its own.
    torch_distributed: bool = True

    def __post_init__(self):
        if self.placement_strategy != "PACK":
            from ray_tpu_torch.models.llama import not_ported

            raise not_ported(
                f"placement groups (placement_strategy="
                f"{self.placement_strategy!r})", _PLACEMENT_ITEM)

    def worker_resources(self) -> Dict[str, float]:
        res = dict(self.resources_per_worker or {})
        res.setdefault("CPU", self.cpus_per_worker)
        if self.use_gpu:
            res.setdefault("GPU", self.gpus_per_worker or 1.0)
        return res

    @property
    def total_workers(self) -> int:
        return self.num_workers


@dataclasses.dataclass
class FailureConfig:
    """Reference: ``air/config.py::FailureConfig``.

    ``max_failures`` governs USER exceptions only (the train loop
    raising). Infrastructure failures — worker death, hung collectives,
    lapsed heartbeats — have their own budget (``RAY_TPU_MAX_RESTARTS``),
    preemptions theirs (``RAY_TPU_MAX_PREEMPTIONS``), and worker-set
    resizes theirs (``RAY_TPU_MAX_RESIZES``); see
    ``ray_tpu_torch/train/elastic.py`` for the full taxonomy.
    """

    max_failures: int = 0  # 0 = no retries, -1 = infinite
    # Per-step watchdog: if no worker reports for this long after the
    # first report, the attempt is declared hung (retryable under the
    # restart budget). None reads RAY_TPU_STEP_WATCHDOG_S; 0 disables.
    # Before the first report the deadline is 10x (compile headroom).
    watchdog_s: Optional[float] = None
    # Fatal-NaN guard: this many CONSECUTIVE reports with a non-finite
    # "loss" ends the run as FATAL (restarting would replay the same
    # divergence). None reads RAY_TPU_NAN_FATAL_REPORTS; 0 disables.
    nan_fatal_reports: Optional[int] = None


@dataclasses.dataclass
class CheckpointConfig:
    """Reference: ``air/config.py::CheckpointConfig`` (top-k retention)."""

    num_to_keep: Optional[int] = None
    checkpoint_score_attribute: Optional[str] = None
    checkpoint_score_order: str = "max"
    checkpoint_frequency: int = 0
    # Persist checkpoints on a background thread (orbax-style: one write
    # in flight; the trainer joins it before restarts/results).
    async_write: bool = False


@dataclasses.dataclass
class RunConfig:
    name: Optional[str] = None
    storage_path: Optional[str] = None
    failure_config: Optional[FailureConfig] = None
    checkpoint_config: Optional[CheckpointConfig] = None
    verbose: int = 1

    def __post_init__(self):
        if self.failure_config is None:
            self.failure_config = FailureConfig()
        if self.checkpoint_config is None:
            self.checkpoint_config = CheckpointConfig()


@dataclasses.dataclass
class Result:
    """Reference: ``air/result.py``."""

    metrics: Optional[Dict[str, Any]]
    checkpoint: Optional[Any]
    path: Optional[str]
    error: Optional[BaseException] = None
    metrics_history: Optional[list] = None

    @property
    def best_checkpoint(self):
        return self.checkpoint

    @property
    def best_checkpoints(self):
        return [(self.checkpoint, self.metrics)] if self.checkpoint else []

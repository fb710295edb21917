"""ray_tpu_torch.train: distributed training library (port of
``ray_tpu.train``; reference: ``python/ray/train``).

``TorchTrainer.fit`` runs the user's ``train_loop_per_worker`` in worker
processes (each owning its cards), polls their reports, persists
checkpoints, and recovers from lost workers, hangs, preemptions and
resizes within per-cause budgets; inside the loop,
``ShardedTrainer.train_step`` is the step, fed by
:class:`DevicePrefetcher` and driven by :class:`AsyncStepLoop`. The
names are the JAX package's, with ``Torch`` for ``Jax``.
"""

from ray_tpu_torch.train.backend_executor import (
    BackendExecutor,
    TorchBackend,
    TrainWorker,
    WorkerGroup,
)
from ray_tpu_torch.train.checkpoint import (
    Checkpoint,
    CheckpointManager,
    load_pytree,
    save_pytree,
)
from ray_tpu_torch.train.config import (
    CheckpointConfig,
    FailureConfig,
    Result,
    RunConfig,
    ScalingConfig,
)
from ray_tpu_torch.train.elastic import ResizeGuard, request_resize
from ray_tpu_torch.train.goodput import GoodputLedger, StragglerDetector
from ray_tpu_torch.train.ingest import DevicePrefetcher, prefetch_to_device
from ray_tpu_torch.train.loop import AsyncStepLoop
from ray_tpu_torch.train.session import (
    get_checkpoint,
    get_checkpoint_plane,
    get_context,
    get_dataset_shard,
    report,
)
from ray_tpu_torch.train.storage import AsyncCheckpointer, StorageContext
from ray_tpu_torch.train.trainer import ControllerState, TorchTrainer

__all__ = [
    "AsyncCheckpointer", "AsyncStepLoop", "BackendExecutor", "Checkpoint",
    "CheckpointConfig", "CheckpointManager", "ControllerState",
    "DevicePrefetcher", "FailureConfig", "GoodputLedger", "ResizeGuard",
    "Result", "RunConfig", "ScalingConfig", "StorageContext",
    "StragglerDetector", "TorchBackend", "TorchTrainer", "TrainWorker",
    "WorkerGroup", "get_checkpoint", "get_checkpoint_plane", "get_context",
    "get_dataset_shard", "load_pytree", "prefetch_to_device", "report",
    "request_resize", "save_pytree",
]

"""ray_tpu_torch.checkpoint: the checkpoint plane (port of
``ray_tpu.checkpoint``): async sharded snapshots with a two-phase-commit
manifest and restore onto any layout, behind
``ShardedTrainer.save_state``/``restore_state``. See ``plane.py`` for the
save/commit/restore protocol and ``preempt.py`` for the preemption plane
(notices through the trainer controller's store, JIT-save guards)."""

from ray_tpu_torch.checkpoint.plane import (
    CKPT_KV_NS,
    CheckpointPlane,
    DictKV,
    SaveHandle,
    StoreKV,
    as_kv,
    inspect_dir,
    list_checkpoints,
    list_manifests_kv,
    load_latest,
    train_state_paths,
)
from ray_tpu_torch.checkpoint.preempt import (
    PreemptionGuard,
    PreemptionWatcher,
    notify_preemption,
    publish_preempt,
    register_preempt_callback,
    unregister_preempt_callback,
)

__all__ = [
    "CKPT_KV_NS",
    "CheckpointPlane",
    "PreemptionGuard",
    "PreemptionWatcher",
    "DictKV",
    "SaveHandle",
    "StoreKV",
    "as_kv",
    "inspect_dir",
    "list_checkpoints",
    "list_manifests_kv",
    "load_latest",
    "notify_preemption",
    "publish_preempt",
    "register_preempt_callback",
    "train_state_paths",
    "unregister_preempt_callback",
]

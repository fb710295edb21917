"""ray_tpu_torch.checkpoint: the checkpoint plane (port of
``ray_tpu.checkpoint``): async sharded snapshots with a two-phase-commit
manifest and restore onto any layout, behind
``ShardedTrainer.save_state``/``restore_state``. See ``plane.py`` for the
save/commit/restore protocol. The preemption plane (``preempt.py``)
rides the runtime and is not ported yet."""

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

__all__ = [
    "CKPT_KV_NS",
    "CheckpointPlane",
    "DictKV",
    "SaveHandle",
    "StoreKV",
    "as_kv",
    "inspect_dir",
    "list_checkpoints",
    "list_manifests_kv",
    "load_latest",
    "train_state_paths",
]

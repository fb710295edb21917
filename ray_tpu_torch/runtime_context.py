"""Runtime context: introspection of the current job/task/actor/node (the
port's copy of ``ray_tpu/runtime_context.py``).

Re-design of the reference (reference: ``python/ray/runtime_context.py``).
"""

from __future__ import annotations

from typing import Dict, Optional

from ray_tpu_torch._private import worker as _worker


class RuntimeContext:
    @property
    def _core(self):
        return _worker.global_worker().core

    def get_job_id(self) -> str:
        return self._core.job_id.hex()

    def get_node_id(self) -> str:
        return self._core.node_id.hex()

    def get_task_id(self) -> Optional[str]:
        from ray_tpu_torch._private.runtime.local import current_task_context

        ctx = current_task_context()
        return ctx.task_id.hex() if ctx else None

    def get_actor_id(self) -> Optional[str]:
        from ray_tpu_torch._private.runtime.local import current_task_context

        ctx = current_task_context()
        return ctx.actor_id.hex() if ctx and ctx.actor_id else None

    def get_actor_name(self) -> Optional[str]:
        from ray_tpu_torch._private.runtime.local import current_task_context

        ctx = current_task_context()
        if ctx is None or ctx.actor_id is None:
            return None
        return self._core.actor_state(ctx.actor_id).get("name")

    def get_worker_id(self) -> str:
        # In process every task and actor runs in the driver's worker, whose
        # id is the node's.
        return self._core.node_id.hex()

    def get_assigned_resources(self) -> Dict[str, float]:
        # Local mode assigns no resource ids (no card ids, as JAX's local
        # mode assigns no chip ids).
        return {}

    def get_placement_group_id(self) -> Optional[str]:
        pg = self._core.current_placement_group_id()
        return pg.hex() if pg else None

    def was_current_actor_reconstructed(self) -> bool:
        return False

    @property
    def namespace(self) -> str:
        return _worker.global_worker().namespace

    def get_runtime_env_string(self) -> str:
        return "{}"


_runtime_context = RuntimeContext()


def get_runtime_context() -> RuntimeContext:
    return _runtime_context

"""ray_tpu_torch.serve: model serving on the port's own runtime (the port
of ``ray_tpu.serve``).

Deployments run in replica processes that the serving process's
controller spawns (:mod:`ray_tpu_torch.runtime`); handles route to them,
the HTTP ingress serves them, and streams survive a replica's death
through the recovery journal (:mod:`~ray_tpu_torch.serve.recovery`).
:mod:`~ray_tpu_torch.serve.kv_transfer` moves KV blocks between a
prefill-role and a decode-role engine in one process; its channel
between replicas waits for ROADMAP item 6c.
"""

from ray_tpu_torch.serve.api import (
    Application,
    Deployment,
    DeploymentHandle,
    DeploymentResponse,
    DeploymentResponseGenerator,
    delete,
    deployment,
    drain,
    get_deployment_handle,
    register_role_group,
    run,
    shutdown,
    start,
    start_grpc,
    start_http,
    stop_http,
)
from ray_tpu_torch.serve.batching import batch
from ray_tpu_torch.serve.multiplex import get_multiplexed_model_id, multiplexed

__all__ = [
    "Application", "Deployment", "DeploymentHandle", "DeploymentResponse",
    "DeploymentResponseGenerator", "batch", "delete", "deployment", "drain",
    "get_deployment_handle", "get_multiplexed_model_id", "multiplexed",
    "register_role_group", "run", "shutdown", "start", "start_grpc",
    "start_http", "stop_http",
]

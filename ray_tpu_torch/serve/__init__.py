"""ray_tpu_torch.serve: model serving on the port's own runtime (the port
of ``ray_tpu.serve``).

Deployments run in replica processes that the serving process's
controller spawns (:mod:`ray_tpu_torch.runtime`); handles route to them,
the HTTP ingress serves them, and streams survive a replica's death
through the recovery journal (:mod:`~ray_tpu_torch.serve.recovery`).
A role group (:func:`register_role_group`) splits a stream across a
prefill and a decode deployment, the KV blocks crossing between their
replicas through :mod:`~ray_tpu_torch.serve.kv_transfer`.
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
    get_role_group,
    register_role_group,
    run,
    shutdown,
    start,
    start_grpc,
    start_http,
    stop_http,
    unregister_role_group,
)
from ray_tpu_torch.serve.batching import batch
from ray_tpu_torch.serve.multiplex import get_multiplexed_model_id, multiplexed

__all__ = [
    "Application", "Deployment", "DeploymentHandle", "DeploymentResponse",
    "DeploymentResponseGenerator", "batch", "delete", "deployment", "drain",
    "get_deployment_handle", "get_multiplexed_model_id", "get_role_group",
    "multiplexed", "register_role_group", "run", "shutdown", "start",
    "start_grpc", "start_http", "stop_http", "unregister_role_group",
]

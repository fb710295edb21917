"""ray_tpu_torch: the PyTorch/CUDA port of ray_tpu.

The package mirrors ``ray_tpu``'s module paths (``ops/...``,
``models/...``) so each function has an obvious counterpart, and keeps
the JAX package's parameter layouts so weights carry across unchanged
(:mod:`ray_tpu_torch.interop`). It imports ``torch`` and never ``jax``
or anything of ``ray_tpu``: what it needs of a host-only module there
(the block allocator, the sampling params) is copied here.

The top level exports JAX's core API (``init``, ``remote``, ``get``,
``put``, ``wait``, actors and object refs) over the in-process runtime
(:mod:`ray_tpu_torch._private.runtime.local`). Importing the package
imports no torch: the fork server and every replica process import it.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
The TPU's Pallas kernels become CUDA kernels written for Hopper
(``sm_90a``), built from ``ops/csrc`` at first use by
:mod:`ray_tpu_torch.ops._build`.
"""

from ray_tpu_torch import exceptions
from ray_tpu_torch._private.object_ref import ObjectRef, ObjectRefGenerator
from ray_tpu_torch._private.worker import (
    available_resources,
    cancel,
    cluster_resources,
    get,
    get_actor,
    init,
    is_initialized,
    kill,
    list_named_actors,
    nodes,
    put,
    shutdown,
    wait,
)
from ray_tpu_torch.actor import exit_actor, method
from ray_tpu_torch.remote_function import make_remote as remote
from ray_tpu_torch.runtime_context import get_runtime_context

__version__ = "0.1.0"

__all__ = [
    "ObjectRef",
    "ObjectRefGenerator",
    "available_resources",
    "cancel",
    "cluster_resources",
    "exceptions",
    "exit_actor",
    "get",
    "get_actor",
    "get_runtime_context",
    "init",
    "is_initialized",
    "kill",
    "list_named_actors",
    "method",
    "nodes",
    "put",
    "remote",
    "shutdown",
    "wait",
    "__version__",
]

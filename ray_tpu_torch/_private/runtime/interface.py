"""CoreRuntime: the per-process runtime interface behind the public API
(the port's copy of ``ray_tpu/_private/runtime/interface.py``).

Re-design of the reference CoreWorker boundary (reference:
``src/ray/core_worker/core_worker.h:166`` — SubmitTask/Put/Get/Wait/
CreateActor etc. exposed to the language frontend). The port has one
implementation, :class:`ray_tpu_torch._private.runtime.local.LocalRuntime`
(in-process execution on threads); JAX's ``ClusterRuntime``, the client of
a node daemon and control plane, is queued in ROADMAP.md.
"""

from __future__ import annotations

import abc
from concurrent.futures import Future
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from ray_tpu_torch._private.ids import ActorID, ObjectID
from ray_tpu_torch._private.object_ref import ObjectRef
from ray_tpu_torch._private.options import RemoteOptions


class CoreRuntime(abc.ABC):
    # -- objects ----------------------------------------------------------
    @abc.abstractmethod
    def put(self, value: Any, owner_ref: Optional[ObjectRef] = None) -> ObjectRef: ...

    @abc.abstractmethod
    def get(self, refs: Sequence[ObjectRef], timeout: Optional[float]) -> List[Any]: ...

    @abc.abstractmethod
    def wait(
        self, refs: Sequence[ObjectRef], num_returns: int, timeout: Optional[float],
        fetch_local: bool,
    ) -> Tuple[List[ObjectRef], List[ObjectRef]]: ...

    @abc.abstractmethod
    def free(self, refs: Sequence[ObjectRef]) -> None: ...

    # -- tasks ------------------------------------------------------------
    @abc.abstractmethod
    def submit_task(
        self, function: Callable, function_name: str, args: tuple, kwargs: dict,
        options: RemoteOptions,
    ) -> List[ObjectRef]: ...

    @abc.abstractmethod
    def cancel(self, ref: ObjectRef, force: bool, recursive: bool) -> None: ...

    # -- actors -----------------------------------------------------------
    @abc.abstractmethod
    def create_actor(
        self, cls: type, args: tuple, kwargs: dict, options: RemoteOptions
    ) -> "ActorID": ...

    @abc.abstractmethod
    def submit_actor_task(
        self, actor_id: ActorID, method_name: str, args: tuple, kwargs: dict,
        options: RemoteOptions,
    ) -> List[ObjectRef]: ...

    @abc.abstractmethod
    def kill_actor(self, actor_id: ActorID, no_restart: bool) -> None: ...

    @abc.abstractmethod
    def get_named_actor(self, name: str, namespace: Optional[str]): ...

    @abc.abstractmethod
    def list_named_actors(self, all_namespaces: bool) -> List[Any]: ...

    # -- references -------------------------------------------------------
    def add_local_reference(self, ref: ObjectRef) -> None:
        pass

    def remove_local_reference(self, object_id: ObjectID) -> None:
        pass

    # -- introspection ----------------------------------------------------
    @abc.abstractmethod
    def as_future(self, ref: ObjectRef) -> Future: ...

    @abc.abstractmethod
    def nodes(self) -> List[Dict[str, Any]]: ...

    @abc.abstractmethod
    def cluster_resources(self) -> Dict[str, float]: ...

    @abc.abstractmethod
    def available_resources(self) -> Dict[str, float]: ...

    # -- lifecycle --------------------------------------------------------
    @abc.abstractmethod
    def shutdown(self) -> None: ...

"""ActorClass / ActorHandle: the actor frontend (the port's copy of
``ray_tpu/actor.py``).

Re-design of the reference actor API (reference: ``python/ray/actor.py`` —
``ActorClass`` :602, ``ActorClass._remote`` :890, ``ActorHandle`` :1265):
``@ray_tpu_torch.remote`` on a class yields an :class:`ActorClass`;
``.remote(*args)`` creates the actor through the core runtime and returns an
:class:`ActorHandle` whose attribute access yields :class:`ActorMethod`
proxies submitting ordered actor tasks.
"""

from __future__ import annotations

import functools
from typing import Any, Dict, Optional

from ray_tpu_torch._private import worker as _worker
from ray_tpu_torch._private.ids import ActorID
from ray_tpu_torch._private.options import RemoteOptions, is_streaming


def method(**method_options):
    """Decorator for actor methods: ``@ray_tpu_torch.method(num_returns=2)``
    (reference: ``python/ray/actor.py::method``)."""

    def decorator(m):
        m.__ray_tpu_method_options__ = method_options
        return m

    return decorator


class ActorMethod:
    def __init__(self, handle: "ActorHandle", method_name: str,
                 method_options: Optional[Dict[str, Any]] = None):
        self._handle = handle
        self._method_name = method_name
        self._method_options = method_options or {}

    def __call__(self, *args, **kwargs):
        raise TypeError(
            f"Actor method {self._method_name!r} cannot be called directly. "
            f"Use .{self._method_name}.remote() instead.")

    def remote(self, *args, **kwargs):
        return self._remote(args, kwargs)

    def options(self, **overrides):
        new = ActorMethod(self._handle, self._method_name,
                          {**self._method_options, **overrides})
        return new

    def _remote(self, args, kwargs):
        opts = self._handle._options.merged_with(
            {k: v for k, v in self._method_options.items()
             if k in ("num_returns",)})
        refs = _worker.global_worker().core.submit_actor_task(
            self._handle._actor_id, self._method_name, args, kwargs, opts)
        # Same source of truth as submit_actor_task: the merged options
        # (a class-level num_returns="streaming" must stream too).
        num_returns = opts.num_returns
        if is_streaming(num_returns):
            from ray_tpu_torch._private.object_ref import ObjectRefGenerator

            return ObjectRefGenerator(refs[0],
                                      owner_address=refs[0].owner_address())
        if num_returns == 1:
            return refs[0]
        return refs

    def bind(self, *args, **kwargs):
        from ray_tpu_torch.dag import ActorMethodNode

        return ActorMethodNode(self._handle, self._method_name, args, kwargs)


class ActorHandle:
    def __init__(self, actor_id: ActorID, cls: type, options: RemoteOptions):
        self._actor_id = actor_id
        self._cls = cls
        self._options = options
        self._method_option_map = {
            name: getattr(m, "__ray_tpu_method_options__")
            for name, m in vars(cls).items()
            if callable(m) and hasattr(m, "__ray_tpu_method_options__")
        }

    @classmethod
    def _from_actor_id(cls, actor_id, actor_cls, options):
        return cls(actor_id, actor_cls, options)

    def __getattr__(self, name: str):
        if name.startswith("_"):
            raise AttributeError(name)
        if not hasattr(self._cls, name):
            raise AttributeError(
                f"Actor class {self._cls.__name__!r} has no method {name!r}")
        return ActorMethod(self, name, self._method_option_map.get(name))

    def __repr__(self):
        return (f"ActorHandle({self._cls.__name__}, "
                f"{self._actor_id.hex()[:16]})")

    def __hash__(self):
        return hash(self._actor_id)

    def __eq__(self, other):
        return isinstance(other, ActorHandle) and other._actor_id == self._actor_id

    def __reduce__(self):
        return (_rebuild_handle, (self._actor_id.binary(), self._cls, self._options))

    def _actor_state(self):
        core = _worker.global_worker().core
        state = getattr(core, "actor_state", None)
        return state(self._actor_id) if state else {}


def _rebuild_handle(actor_id_binary: bytes, cls, options) -> ActorHandle:
    return ActorHandle(ActorID(actor_id_binary), cls, options)


class ActorClass:
    def __init__(self, cls: type, options: RemoteOptions):
        self._cls = cls
        self._options = options
        functools.update_wrapper(self, cls, updated=[])

    def __call__(self, *args, **kwargs):
        raise TypeError(
            f"Actor class {self._cls.__name__!r} cannot be instantiated directly. "
            f"Use {self._cls.__name__}.remote() instead.")

    def remote(self, *args, **kwargs) -> ActorHandle:
        return self._remote(args, kwargs, self._options)

    def options(self, **option_overrides) -> "ActorClass":
        new = ActorClass.__new__(ActorClass)
        new._cls = self._cls
        new._options = self._options.merged_with(option_overrides)
        functools.update_wrapper(new, self._cls, updated=[])
        return new

    def _remote(self, args, kwargs, options: RemoteOptions) -> ActorHandle:
        import dataclasses

        from ray_tpu_torch._private.concurrency import class_is_async

        options = dataclasses.replace(
            options, _is_async_actor=class_is_async(self._cls))
        core = _worker.global_worker().core
        if options.name and options.get_if_exists:
            try:
                actor_id, cls, opts = core.get_named_actor(
                    options.name, options.namespace)
                return ActorHandle(actor_id, cls, opts)
            except ValueError:
                pass
        actor_id = core.create_actor(self._cls, args, kwargs, options)
        return ActorHandle(actor_id, self._cls, options)

    def bind(self, *args, **kwargs):
        from ray_tpu_torch.dag import ClassNode

        return ClassNode(self, args, kwargs)

    @property
    def cls(self):
        return self._cls


def exit_actor():
    """Called inside an actor method to terminate the actor after this call
    (reference: ``ray.actor.exit_actor``)."""
    from ray_tpu_torch import exceptions

    raise exceptions.AsyncioActorExit("exit_actor() called")

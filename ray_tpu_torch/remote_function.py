"""RemoteFunction: the object returned by ``@ray_tpu_torch.remote`` on a
function (the port's copy of ``ray_tpu/remote_function.py``).

Re-design of the reference (reference: ``python/ray/remote_function.py`` —
``RemoteFunction._remote`` :303): holds the user function plus default
options; ``.remote(*args)`` submits through the core runtime, ``.options()``
returns a shallow clone with overridden options.

The callable itself is submitted. JAX pickles a remote function once
(``_private/fn_ref.py``'s ``FnRef``) for the cluster's wire; the in-process
runtime has no wire, so nothing is serialized, and a closure that captures
an ``ObjectRef`` keeps that ref (and its object) alive while it runs.
"""

from __future__ import annotations

import functools

from ray_tpu_torch._private import worker as _worker
from ray_tpu_torch._private.options import (RemoteOptions, is_streaming,
                                            options_from_decorator_kwargs)


class RemoteFunction:
    def __init__(self, function, options: RemoteOptions):
        if not callable(function):
            raise TypeError("@remote must decorate a callable")
        self._function = function
        self._options = options
        self._function_name = getattr(function, "__qualname__",
                                      getattr(function, "__name__", "anonymous"))
        functools.update_wrapper(self, function)

    def __call__(self, *args, **kwargs):
        raise TypeError(
            f"Remote function {self._function_name!r} cannot be called directly. "
            f"Use {self._function_name}.remote() instead.")

    def remote(self, *args, **kwargs):
        return self._remote(args, kwargs, self._options)

    def options(self, **option_overrides) -> "RemoteFunction":
        new = RemoteFunction.__new__(RemoteFunction)
        new._function = self._function
        new._function_name = self._function_name
        new._options = self._options.merged_with(option_overrides)
        functools.update_wrapper(new, self._function)
        return new

    def _remote(self, args, kwargs, options: RemoteOptions):
        refs = _worker.global_worker().core.submit_task(
            self._function, self._function_name, args, kwargs, options)
        if is_streaming(options.num_returns):
            # Generator task: refs[0] carries the final item count; items
            # stream out at deterministic ids (reference: ObjectRefStream).
            from ray_tpu_torch._private.object_ref import ObjectRefGenerator

            return ObjectRefGenerator(refs[0],
                                      owner_address=refs[0].owner_address())
        if options.num_returns == 1:
            return refs[0]
        return refs

    @property
    def func(self):
        """The underlying (non-remote) function."""
        return self._function

    def bind(self, *args, **kwargs):
        """Build a DAG node for compiled-graph execution (ray_tpu_torch.dag)."""
        from ray_tpu_torch.dag import FunctionNode

        return FunctionNode(self, args, kwargs)


def make_remote(function_or_class=None, **kwargs):
    """Implements ``@ray_tpu_torch.remote`` / ``@ray_tpu_torch.remote(**opts)``."""
    import inspect

    def decorator(target):
        if inspect.isclass(target):
            from ray_tpu_torch.actor import ActorClass

            return ActorClass(target, options_from_decorator_kwargs(kwargs, True))
        return RemoteFunction(target, options_from_decorator_kwargs(kwargs, False))

    if function_or_class is not None:
        # Bare @remote with no arguments.
        if kwargs:
            raise TypeError("remote() takes either a function/class or options")
        return decorator(function_or_class)
    return decorator

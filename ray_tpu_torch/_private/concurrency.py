"""Shared actor-concurrency helpers (the port's copy of
``ray_tpu/_private/concurrency.py``).

One source of truth for "is this class an async actor?" and "which
concurrency group does this method belong to?", read by the in-process
runtime (``runtime/local.py``) and kept apart from it, as in JAX, where
the cluster worker shares it (reference: ``src/ray/core_worker/transport/concurrency_group_manager.h``
— one manager shared by every transport).
"""

from __future__ import annotations

import inspect
from typing import Dict, Optional


def class_is_async(cls: type) -> bool:
    """True when any (possibly inherited) method is a coroutine or
    async-generator function — the class runs as an async actor on a
    dedicated event loop (reference: async actors, ``fiber.h``)."""
    return any(
        inspect.iscoroutinefunction(getattr(cls, name, None))
        or inspect.isasyncgenfunction(getattr(cls, name, None))
        for name in dir(cls))


def effective_max_concurrency(is_async: bool,
                              max_concurrency: Optional[int]) -> int:
    """Resolve the ``max_concurrency`` option: UNSET (None) means ordered
    execution for sync actors and 1000 concurrent awaits for async actors
    (the reference default); an explicit value — including an explicit
    1 on an async actor — is honored as-is. Shared by the submitter
    window sizing and both executors so they can't desynchronize."""
    if max_concurrency is None:
        return 1000 if is_async else 1
    return max(1, int(max_concurrency))


def group_of(method, groups: Optional[Dict[str, int]]) -> str:
    """Concurrency-group name for a bound method ("" = default group).

    The group rides the ``@ray_tpu_torch.method(concurrency_group=...)``
    decorator attribute, which pickles with the class — executors read it
    straight off the instance. Unknown group names raise ``ValueError``.
    """
    opts = getattr(method, "__ray_tpu_method_options__", None) or {}
    group = opts.get("concurrency_group", "")
    if group and group not in (groups or {}):
        raise ValueError(
            f"method declares concurrency_group={group!r} but the "
            f"actor class only defines groups {sorted(groups or {})}")
    return group

"""Per-task placement-group capture context (the port's copy of
``ray_tpu/_private/pg_context.py``).

Reference: ``placement_group_capture_child_tasks`` semantics — a task running
inside a capturing placement group schedules its children into the same
group by default. The executing worker sets this context around user code;
submit paths read it when no explicit placement option is given.
"""

from __future__ import annotations

import contextvars
from typing import Optional, Tuple

# ContextVar, not threading.local: plain worker threads each get their own
# context (same semantics as before), and on an async actor's event loop
# every asyncio task carries its own copy, so interleaved coroutines don't
# race on set/clear.
_ctx: contextvars.ContextVar[Optional[Tuple[bytes, int, bool]]] = \
    contextvars.ContextVar("ray_tpu_pg_context", default=None)


def set(group_id: bytes, bundle_index: int, capture: bool) -> None:  # noqa: A001
    _ctx.set((group_id, bundle_index, capture))


def clear() -> None:
    _ctx.set(None)


def get() -> Optional[Tuple[bytes, int, bool]]:
    return _ctx.get()

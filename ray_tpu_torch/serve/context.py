"""Serve request context: the per-request identity that rides the call
(the port's copy of ``ray_tpu/serve/context.py``).

Reference: ``ray.serve.context._serve_request_context`` — the reference
threads a ``RequestContext`` (request id, route, multiplexed model id)
through a ContextVar so replica user code can attribute work to the
in-flight request. Here the context also carries the TRACE linkage
(trace id + parent span id minted at ingress/route), which is how the
continuous-batching engine connects its lifecycle spans — emitted from
its own tick thread, long after the handler returned — to the request's
trace.

A ContextVar (not a thread-local) because the replica runs sync user
code in executor threads via ``contextvars.copy_context().run`` — the
copied context carries this across the thread hop, exactly like the
multiplexed model id.
"""

from __future__ import annotations

import contextvars
from typing import Any, Dict, Optional

_request_ctx: contextvars.ContextVar[Optional[Dict[str, Any]]] = \
    contextvars.ContextVar("serve_request_context", default=None)


def get_request_context() -> Optional[Dict[str, Any]]:
    """The in-flight serve request's context, or None outside a serve
    call. Keys: ``request_id``, ``trace_id``, ``parent_span_id``,
    ``deployment``, ``tenant`` (the multiplexed model id, '' for
    single-tenant deployments), and — on a request the recovery journal
    re-dispatched after replica death or a drain reject — ``attempt``
    (1-based redispatch count; absent on the first attempt). The ids
    stay IDENTICAL across attempts: a resumed request is one trace whose
    engine spans land on two replicas."""
    return _request_ctx.get()


def get_request_attempt() -> int:
    """Redispatch count of the in-flight request (0 = first attempt —
    also outside any serve call)."""
    ctx = _request_ctx.get()
    return int(ctx.get("attempt", 0)) if ctx else 0


def _set_request_context(ctx: Optional[Dict[str, Any]]):
    return _request_ctx.set(ctx)


def _reset_request_context(token) -> None:
    _request_ctx.reset(token)


__all__ = ["get_request_attempt", "get_request_context"]

"""Model multiplexing: many models served by few replicas, LRU-loaded
(the port's copy of ``ray_tpu/serve/multiplex.py``).

Reference: ``python/ray/serve/api.py`` ``@serve.multiplexed`` +
``serve/_private/multiplex.py`` ``ModelMultiplexWrapper`` — a replica
holds up to ``max_num_models_per_replica`` models in an LRU cache; the
router keeps requests for one model id on the same replica so its cache
hits. TPU-native simplification: affinity comes from consistent hashing
of the model id over the replica set (the reference pushes loaded-model
reports through the controller; hashing gives the same steady-state
locality without the feedback loop).
"""

from __future__ import annotations

import contextvars
import functools
import inspect
import os
import threading
import time
from collections import OrderedDict
from typing import Callable, Dict, Optional, Tuple

_model_id_ctx: contextvars.ContextVar[str] = contextvars.ContextVar(
    "serve_multiplexed_model_id", default="")


def get_multiplexed_model_id() -> str:
    """Model id of the in-flight request (reference:
    ``serve.get_multiplexed_model_id``); "" outside a multiplexed call."""
    return _model_id_ctx.get()


def _set_model_id(model_id: str):
    return _model_id_ctx.set(model_id)


def _reset_model_id(token) -> None:
    _model_id_ctx.reset(token)


def get_request_tenant() -> str:
    """The in-flight request's TENANT for telemetry attribution: the
    multiplexed model id ('' for single-tenant deployments), which the
    engine keeps in each request's trace (the JAX package's
    ``ray_tpu_serve_request_*`` histograms tag it; in the port they wait
    for ROADMAP item 9). Delegates to
    :func:`get_multiplexed_model_id` — one source of truth if a
    default-tenant rule ever lands."""
    return get_multiplexed_model_id()


def multiplexed(func: Optional[Callable] = None, *,
                max_num_models_per_replica: int = 3):
    """Decorate a model-loader method ``(self, model_id) -> model``: calls
    hit a per-replica LRU so at most ``max_num_models_per_replica`` models
    stay resident; older ones are evicted on overflow."""

    def decorate(loader: Callable):
        cache_attr = f"__serve_mux_cache_{loader.__name__}"

        def _cache(self) -> OrderedDict:
            cache = getattr(self, cache_attr, None)
            if cache is None:
                cache = OrderedDict()
                setattr(self, cache_attr, cache)
            return cache

        if inspect.iscoroutinefunction(loader):
            @functools.wraps(loader)
            async def wrapper(self, model_id: str):
                cache = _cache(self)
                if model_id in cache:
                    cache.move_to_end(model_id)
                    return cache[model_id]
                model = await loader(self, model_id)
                cache[model_id] = model
                while len(cache) > max_num_models_per_replica:
                    cache.popitem(last=False)
                return model
        else:
            @functools.wraps(loader)
            def wrapper(self, model_id: str):
                cache = _cache(self)
                if model_id in cache:
                    cache.move_to_end(model_id)
                    return cache[model_id]
                model = loader(self, model_id)
                cache[model_id] = model
                while len(cache) > max_num_models_per_replica:
                    cache.popitem(last=False)
                return model

        wrapper.__serve_multiplexed__ = True
        return wrapper

    if func is not None:
        return decorate(func)
    return decorate


# --------------------------------------------------- per-tenant rate limits
class TokenBucket:
    """Classic token bucket: ``rate`` tokens/s refill up to ``burst``.
    ``try_acquire`` is non-blocking — on refusal it returns the seconds
    until the next token, which the ingress turns into a Retry-After
    header instead of queueing the request."""

    __slots__ = ("rate", "burst", "tokens", "ts")

    def __init__(self, rate: float, burst: float):
        self.rate = float(rate)
        self.burst = max(float(burst), 1.0)
        # A zero-rate bucket is a hard-disabled tenant: it must refuse
        # from the first request, not grant one burst token.
        self.tokens = self.burst if self.rate > 0 else 0.0
        self.ts = time.monotonic()

    def try_acquire(self, now: Optional[float] = None) -> Optional[float]:
        now = time.monotonic() if now is None else now
        self.tokens = min(self.burst,
                          self.tokens + (now - self.ts) * self.rate)
        self.ts = now
        if self.tokens >= 1.0:
            self.tokens -= 1.0
            return None
        if self.rate <= 0:
            return 60.0          # hard-disabled tenant: long back-off
        return (1.0 - self.tokens) / self.rate


class TenantRateLimiter:
    """Per-tenant token buckets for the ingress admission gate (tenant =
    the multiplexed model id; '' is the anonymous tenant). Limits come
    from ``set_limit`` per tenant, falling back to the
    ``RAY_TPU_TENANT_RPS`` / ``RAY_TPU_TENANT_BURST`` env defaults
    (unset/0 RPS = unlimited)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._limits: Dict[str, Tuple[float, float]] = {}
        self._buckets: Dict[str, TokenBucket] = {}

    def set_limit(self, tenant: str, rps: float,
                  burst: Optional[float] = None) -> None:
        """Override one tenant's budget (rps <= 0 disables the tenant;
        burst defaults to max(rps, 1))."""
        with self._lock:
            self._limits[tenant] = (float(rps),
                                    float(burst) if burst is not None
                                    else max(float(rps), 1.0))
            self._buckets.pop(tenant, None)   # rebuild on next acquire

    def clear_limit(self, tenant: str) -> None:
        with self._lock:
            self._limits.pop(tenant, None)
            self._buckets.pop(tenant, None)

    def _default_limit(self) -> Optional[Tuple[float, float]]:
        rps = float(os.environ.get("RAY_TPU_TENANT_RPS", "0") or 0)
        if rps <= 0:
            return None          # unlimited by default
        burst = float(os.environ.get("RAY_TPU_TENANT_BURST", "0") or 0)
        return rps, (burst if burst > 0 else max(rps, 1.0))

    def try_acquire(self, tenant: str) -> Optional[float]:
        """None = admitted; else seconds until this tenant's next token
        (the Retry-After the ingress should advertise)."""
        with self._lock:
            bucket = self._buckets.get(tenant)
            if bucket is None:
                limit = self._limits.get(tenant)
                explicit = limit is not None
                if limit is None:
                    limit = self._default_limit()
                if limit is None:
                    return None  # unlimited tenant: no bucket at all
                if not explicit and limit[0] <= 0:
                    return None
                bucket = self._buckets[tenant] = TokenBucket(*limit)
            return bucket.try_acquire()


_rate_limiter: Optional[TenantRateLimiter] = None
_rate_limiter_lock = threading.Lock()


def tenant_rate_limiter() -> TenantRateLimiter:
    """Process-wide limiter shared by every ingress (HTTP + gRPC)."""
    global _rate_limiter
    with _rate_limiter_lock:
        if _rate_limiter is None:
            _rate_limiter = TenantRateLimiter()
        return _rate_limiter

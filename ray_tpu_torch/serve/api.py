"""ray_tpu_torch.serve: model serving on the port's runtime (the port of
``ray_tpu/serve/api.py``).

* ``Deployment`` / ``Application`` / :func:`deployment`: the deployment
  record (``options``, ``bind``, ``init_kwargs``) as in JAX
  (``:1786-1858``);
* the controller is :class:`~ray_tpu_torch.runtime.controller.ServeController`,
  an object of the serving process that owns the replica processes
  (:mod:`ray_tpu_torch.runtime.replica`); :func:`run` starts it on first
  use (:func:`start` gives it a KV);
* :class:`DeploymentHandle` routes each call as JAX's does: power of two
  choices over in-flight counts, multiplexed-model affinity by a hash of
  the model id, prefix affinity by rendezvous hashing tempered by
  replica pressure, and eviction of a replica seen dead or draining;
* :class:`DeploymentResponse` (unary, retried through the recovery
  budget) and :class:`DeploymentResponseGenerator` (streams; the ingress
  wraps them in the recovery journal, :mod:`ray_tpu_torch.serve.recovery`);
* the HTTP ingress (:func:`start_http`, :mod:`ray_tpu_torch.serve.proxy`).

* role groups (:func:`register_role_group`): a logical name for a
  (prefill, decode) pair of deployments, held by the controller beside
  the routes (and in its KV); the ingress classifies a stream to the
  name and splits it across the pair
  (:class:`~ray_tpu_torch.serve.recovery.DisaggRecoverableStream`).

The router records JAX's serve series (``SERVE_REQUESTS``,
``SERVE_LATENCY``, ``SERVE_QUEUE_DEPTH``, ``SERVE_ROUTER_AFFINITY``), and
under ``RAY_TPU_TRACING=1`` a ``serve.route`` span a dispatch whose id
rides the request context to the replica, where the engine's spans
parent to it; a unary retry emits ``serve.resume``.

Not ported: the autoscaler, deployment graphs (a bound ``Application``
as an init argument), config-file deploys, placement groups and the gRPC ingress (ROADMAP.md
queue A, item 17; the autoscaler, item 19). Route changes reach handles by a callback, not
a pubsub.
"""

from __future__ import annotations

import hashlib
import inspect
import os
import random
import threading
import time
import zlib
from typing import Any, Dict, List, Optional

from ray_tpu_torch import exceptions
from ray_tpu_torch._private import chaos
from ray_tpu_torch._private import events as _events
from ray_tpu_torch._private import metrics_defs as mdefs
from ray_tpu_torch.models.llama import not_ported
from ray_tpu_torch.util import tracing
from ray_tpu_torch.util.metrics import prometheus_text

#: Seconds a call waits for a deployment with no routed replica to get
#: one (JAX waits 10 s for an actor; a replica process cold-starts a
#: model, CUDA included).
NO_REPLICA_WAIT_S = 120.0

_LATER_ITEM = "item 17 (the serve leftovers)"

_controller = None
_controller_lock = threading.Lock()


def start(kv=None):
    """Start this process's serve controller (idempotent); ``kv`` is its
    KV (None, a dict, or a ``torch.distributed`` store). Returns it."""
    global _controller
    with _controller_lock:
        if _controller is None:
            from ray_tpu_torch.runtime.controller import ServeController

            _controller = ServeController(kv)
        return _controller


def _get_controller():
    if _controller is None:
        raise RuntimeError("serve is not running in this process: call "
                           "serve.run (or serve.start) first")
    return _controller


# ------------------------------------------------------------ role groups
# A logical deployment name that maps to a (prefill, decode) pair of
# deployments. The ingress consults it to classify-and-split requests;
# everything else sees two ordinary deployments. ``serve.run`` the two
# deployments first, then declare the group (:func:`deploy_disagg_llama`
# does all three).
def register_role_group(name: str, *, prefill: str, decode: str) -> None:
    """Declare ``name`` as a disaggregated role group: streaming LLM
    requests to ``name`` are classified at the ingress and either split
    (prefill on ``prefill``, KV handoff, decode on ``decode``) or sent
    to ``decode`` whole (its engines run colocated admission too)."""
    if not prefill or not decode:
        raise ValueError("role group needs both a prefill and a decode "
                         "deployment name")
    start().set_role_group(name, {"prefill": prefill, "decode": decode})


def get_role_group(name: str) -> Optional[Dict[str, str]]:
    """``{"prefill": ..., "decode": ...}`` of a registered group, else
    None (also when serve is not running)."""
    controller = _controller
    return None if controller is None else controller.get_role_group(name)


def unregister_role_group(name: str) -> bool:
    controller = _controller
    return controller is not None and controller.delete_role_group(name)


# -------------------------------------------------------------- responses
class DeploymentResponse:
    """Future-like unary response (reference: ``DeploymentResponse``)."""

    def __init__(self, future, handle: Optional["DeploymentHandle"] = None,
                 call: Optional[tuple] = None, replica: Any = None):
        self._future = future
        self._handle = handle
        self._call = call
        self._replica = replica
        # Minted at the first retry, so a retried call's resume events
        # chain under one request id (the clean path mints nothing).
        self._request_id = ""

    def _note_flight_resume(self, mode: str, replica=None) -> None:
        """``serve.resume`` for a retry; its cause is inferred from the
        ring: the rejecting replica's own drain, else the deployment's
        newest drain, else the newest drain or chaos firing anywhere."""
        name = self._handle._name
        if not self._request_id:
            self._request_id = tracing.gen_id()
        cause = ""
        if replica is not None:
            cause = _events.latest_event_id(
                ["serve.drain_begin"],
                subject={"deployment": name,
                         "replica": replica.replica_id})
        cause = cause or _events.latest_event_id(
            ["serve.drain_begin"], subject={"deployment": name}) or \
            _events.latest_event_id(["serve.drain_begin", "chaos.inject"])
        _events.emit("serve.resume", cause=cause,
                     subject={"deployment": name,
                              "request_id": self._request_id},
                     mode=mode)

    def result(self, timeout_s: Optional[float] = 60.0):
        """The call's value. A drain reject re-routes for free (bounded by
        ``DRAIN_REJECT_CAP``); a replica death resubmits within the
        resume budget (``RAY_TPU_SERVE_MAX_RESUMES``), and a spent budget
        raises :class:`~ray_tpu_torch.exceptions.ResumeExhaustedError`."""
        from ray_tpu_torch.serve import recovery

        fut, replica = self._future, self._replica
        resumes = 0
        drain_rejects = 0
        while True:
            try:
                out = fut.result(timeout=timeout_s)
                if resumes and self._handle is not None:
                    recovery.note_unary_resumed(self._handle._name,
                                                self._handle._model_id)
                return out
            except exceptions.ReplicaDrainingError:
                # Clean reject: the draining replica did no work.
                if self._handle is None or self._call is None or \
                        drain_rejects >= recovery.DRAIN_REJECT_CAP:
                    raise
                drain_rejects += 1
                recovery.note_unary_retry(self._handle._name,
                                          "drain_reject")
                self._note_flight_resume("drain_reject", replica)
            except exceptions.ActorDiedError as e:
                # Zero response bytes were delivered, so a resubmission
                # cannot double-deliver; it is still budgeted.
                if self._handle is None or self._call is None:
                    raise
                if resumes >= recovery.max_resumes():
                    recovery.note_unary_exhausted(self._handle._name,
                                                  self._handle._model_id)
                    raise recovery.exhausted_error(
                        self._handle._name, resumes) from e
                resumes += 1
                recovery.note_unary_retry(self._handle._name, "resubmit")
                self._note_flight_resume("resubmit", replica)
            self._handle._evict(replica)
            args, kwargs = self._call
            retry = self._handle.remote(*args, **kwargs)
            fut, replica = retry._future, retry._replica


class DeploymentResponseGenerator:
    """Iterates the values of a streaming call as the replica yields them
    (handle ``stream=True``). ``per_item_timeout_s`` bounds each item
    (None: wait indefinitely; a replica's death still ends the wait).
    Carries the serving ``_replica`` so the recovery journal can evict it
    when the stream dies; :meth:`close` abandons the stream, which closes
    the user's generator in the replica."""

    def __init__(self, stream, per_item_timeout_s=None, replica: Any = None):
        self._stream = stream
        self._timeout = per_item_timeout_s
        self._replica = replica

    def __iter__(self):
        return self

    def __next__(self):
        return self._stream.next(self._timeout)

    def close(self) -> None:
        self._stream.close()


# ---------------------------------------------------------------- routing
# In-flight requests this process's routers hold against each deployment
# (the SERVE_QUEUE_DEPTH gauge).
_QUEUE_DEPTH: Dict[str, int] = {}
_QUEUE_DEPTH_LOCK = threading.Lock()


def _queue_depth_delta(deployment: str, delta: int) -> int:
    with _QUEUE_DEPTH_LOCK:
        depth = max(_QUEUE_DEPTH.get(deployment, 0) + delta, 0)
        _QUEUE_DEPTH[deployment] = depth
    return depth


class _RouterState:
    """Routing table + subscription shared by a handle and its clones."""

    def __init__(self):
        self.replicas: List[Any] = []
        self.dirty = True
        self.inflight: Dict[int, int] = {}
        self.lock = threading.Lock()
        self.subscribed = False
        # Controller per-replica load and pressure snapshots, TTL-cached
        # per router (the affinity policy and the admission gate read the
        # cached copy).
        self.shared_loads: List[int] = []
        self.loads_ts = 0.0
        self.shared_pressure: List[Dict[str, Any]] = []
        self.pressure_ts = 0.0

    def invalidate(self) -> None:
        """The replica set changed: per-index snapshots are aligned with
        the old table (caller holds ``lock``)."""
        self.loads_ts = 0.0
        self.pressure_ts = 0.0
        self.shared_loads = []
        self.shared_pressure = []


def _affinity_candidates(prefix_key: str, n: int) -> List[int]:
    """Rendezvous (highest-random-weight) hashing of a prefix
    fingerprint over the replica set: a stable per-key preference order
    that barely reshuffles when the replica count changes. The top TWO
    candidates are the key's home and spill replicas — a hot prefix
    concentrates on at most two KV caches instead of melting one.
    blake2b, not crc32: CRC is affine, so keys differing in a suffix
    byte order the replicas identically and every home collapses onto
    one replica."""

    def weight(i: int) -> bytes:
        return hashlib.blake2b(f"{prefix_key}:{i}".encode(),
                               digest_size=8).digest()

    order = sorted(range(n), key=weight, reverse=True)
    return order[:2] if n >= 2 else order


def _pressure_cost(snap: Optional[Dict[str, Any]], local_inflight: int,
                   hot: float) -> float:
    """Congestion score for one replica: router in-flight + engine queue
    depth, plus a hot-sized penalty when the paged-KV arena has nothing
    left to admit with (free or reclaimable) — an arena-starved replica
    is as bad as a deep queue even when its router counters look calm.
    Unreachable/missing snapshots fall back to the local view only."""
    cost = float(local_inflight)
    if not snap or snap.get("unreachable"):
        return cost
    cost += float(snap.get("queue_depth") or 0)
    cost += float(snap.get("ongoing") or 0)
    total = snap.get("kv_blocks_total") or 0
    if total:
        avail = ((snap.get("kv_blocks_free") or 0)
                 + (snap.get("kv_blocks_cached") or 0))
        if avail <= 0:
            cost += hot
    return cost


def _affinity_pick(prefix_key: str, n: int,
                   pressure: List[Dict[str, Any]],
                   inflight: Dict[int, int],
                   hot: Optional[float] = None) -> tuple:
    """Choose a replica for a prefix-keyed request: stay on the key's
    rendezvous home while it is healthy (below the ``hot`` congestion
    threshold, or no worse than the spill candidate), else spill to the
    second rendezvous choice. Returns ``(index, decision)`` with
    decision in {"affinity", "overflow"}."""
    if hot is None:
        hot = float(os.environ.get("RAY_TPU_AFFINITY_HOT_COST", "8"))
    cands = _affinity_candidates(prefix_key, n)
    if len(cands) == 1:
        return cands[0], "affinity"
    c0, c1 = cands

    def cost(i):
        return _pressure_cost(pressure[i] if i < len(pressure) else None,
                              inflight.get(i, 0), hot)

    if cost(c0) < hot or cost(c0) <= cost(c1):
        return c0, "affinity"
    return c1, "overflow"


class DeploymentHandle:
    """Routes calls to a deployment's replicas. The routing table is
    pushed: a listener registered with the controller on first use marks
    it stale when the replica set changes, and a call that raced a
    replica's death is retried by its response or the recovery journal
    on a live replica."""

    def __init__(self, deployment_name: str, method_name: Optional[str] = None,
                 _router: Optional[_RouterState] = None,
                 _stream: bool = False, _model_id: str = "",
                 _request_ctx: Optional[Dict[str, Any]] = None,
                 _prefix_key: str = ""):
        self._name = deployment_name
        self._method = method_name
        self._stream = _stream
        self._model_id = _model_id
        # Prefix fingerprint (minted at the ingress): routes to the
        # replica most likely to hold the prompt prefix in its radix KV
        # cache, tempered by pressure. "" = pow-2 balancing.
        self._prefix_key = _prefix_key
        # Per-call request context, shipped to the replica (the engine
        # keeps it in the request's record).
        self._request_ctx = _request_ctx
        # Router state is SHARED across options()/method clones.
        self._router = _router or _RouterState()

    def options(self, method_name: Optional[str] = None, *,
                stream: Optional[bool] = None,
                multiplexed_model_id: Optional[str] = None,
                request_context: Optional[Dict[str, Any]] = None,
                prefix_key: Optional[str] = None) -> "DeploymentHandle":
        return DeploymentHandle(
            self._name,
            method_name if method_name is not None else self._method,
            _router=self._router,
            _stream=self._stream if stream is None else stream,
            _model_id=(self._model_id if multiplexed_model_id is None
                       else multiplexed_model_id),
            _request_ctx=(self._request_ctx if request_context is None
                          else request_context),
            _prefix_key=(self._prefix_key if prefix_key is None
                         else prefix_key))

    @property
    def _replicas(self):
        return self._router.replicas

    def __getattr__(self, name):
        if name.startswith("_"):
            raise AttributeError(name)
        return _HandleMethod(self, name)

    def _ensure_subscribed(self):
        st = self._router
        if st.subscribed:
            return
        st.subscribed = True

        def on_event(name: str):
            if name == self._name:
                with st.lock:
                    st.dirty = True
                    st.invalidate()

        _get_controller().subscribe(on_event)

    def _refresh(self, force: bool = False):
        self._ensure_subscribed()
        st = self._router
        if not force and not st.dirty and st.replicas and \
                not any(r.dead for r in st.replicas):
            return
        _, replicas = _get_controller().get_routes(self._name)
        with st.lock:
            changed = [id(r) for r in replicas] != \
                [id(r) for r in st.replicas]
            st.replicas = replicas
            st.dirty = False
            st.inflight = {}
            if changed:
                st.invalidate()

    def _evict(self, replica) -> None:
        """Drop a replica seen dead or draining; refreshed tables re-add
        the live set."""
        st = self._router
        with st.lock:
            st.replicas = [r for r in st.replicas if r is not replica]
            st.inflight = {}
            st.dirty = not st.replicas
            st.invalidate()

    def _choose(self, model_id: str = "", prefix_key: str = ""):
        """Power-of-two-choices over in-flight counts; multiplexed calls
        hash the model id over the replica set so one model's requests
        keep hitting the replica whose LRU holds it; prefix-keyed calls
        route by rendezvous-hashed prefix affinity tempered by pressure."""
        self._refresh()
        deadline = time.monotonic() + NO_REPLICA_WAIT_S
        while not self._replicas and time.monotonic() < deadline:
            # A fresh or recovering deployment may still be starting
            # replicas.
            time.sleep(0.05)
            self._refresh(force=True)
        if not self._replicas:
            raise RuntimeError(f"deployment {self._name!r} has no replicas")
        st = self._router
        shared: List[int] = []
        pressure: List[Dict[str, Any]] = []
        if not model_id and len(self._replicas) > 1:
            if prefix_key:
                pressure = self._fetch_shared_pressure()
            else:
                shared = self._fetch_shared_loads()
        with st.lock:
            n = len(st.replicas)
            if model_id:
                idx = zlib.crc32(model_id.encode()) % n
            elif n == 1:
                idx = 0
            elif prefix_key:
                idx, decision = _affinity_pick(prefix_key, n, pressure,
                                               st.inflight)
                mdefs.SERVE_ROUTER_AFFINITY.inc(
                    tags={"deployment": self._name, "decision": decision})
            else:
                loads = shared if len(shared) == n else None
                a, b = random.sample(range(n), 2)

                def cost(i):
                    return (loads[i] if loads else 0) + \
                        st.inflight.get(i, 0)

                idx = a if cost(a) <= cost(b) else b
            st.inflight[idx] = st.inflight.get(idx, 0) + 1
            return idx, st.replicas[idx]

    LOADS_TTL_S = 0.5
    PRESSURE_TTL_S = 0.5

    def _fetch_shared_loads(self) -> List[int]:
        """Controller per-replica ongoing counts, TTL-cached per router."""
        st = self._router
        now = time.monotonic()
        if now - st.loads_ts < self.LOADS_TTL_S:
            return st.shared_loads
        st.loads_ts = now  # claim the slot first: no thundering herd
        loads = list(_get_controller().get_replica_loads(self._name))
        with st.lock:
            st.shared_loads = loads
        return loads

    def _fetch_shared_pressure(self) -> List[Dict[str, Any]]:
        """Per-replica pressure snapshots, TTL-cached per router: routing
        and ingress admission read the cached copy; one call per TTL
        pays the controller's fan-out."""
        self._ensure_subscribed()
        st = self._router
        now = time.monotonic()
        if now - st.pressure_ts < self.PRESSURE_TTL_S:
            return st.shared_pressure
        if chaos.enabled():
            # A dropped pressure fetch: keep serving whatever the cache
            # holds (possibly nothing); the admission gate and the
            # affinity policy must stay safe on stale data.
            d = chaos.inject("serve_pressure", deployment=self._name)
            if d and d.get("drop"):
                return st.shared_pressure
        st.pressure_ts = now
        snaps = list(_get_controller().get_replica_pressure(self._name))
        with st.lock:
            st.shared_pressure = snaps
        return snaps

    def _observe_done(self, start: float) -> None:
        mdefs.SERVE_LATENCY.observe(time.monotonic() - start,
                                    tags={"deployment": self._name})
        mdefs.SERVE_QUEUE_DEPTH.set(_queue_depth_delta(self._name, -1),
                                    tags={"deployment": self._name})

    def remote(self, *args, **kwargs):
        if not tracing.enabled():
            # Tracing off: one env check, no context work.
            return self._remote_impl(args, kwargs, self._request_ctx)
        rctx = self._request_ctx
        if rctx is None:
            # A direct handle call (no ingress): the request's identity
            # is minted here, continuing the caller's trace if any.
            cur = tracing.current()
            rctx = {"request_id": tracing.gen_id(),
                    "trace_id": cur[0] if cur else tracing.gen_id(),
                    "parent_span_id": cur[1] if cur else "",
                    "deployment": self._name, "tenant": self._model_id}
        parent = rctx.get("parent_span_id", "")
        # The route span's id is chosen first: the replica's engine spans
        # (recorded long after this returns) parent to it.
        route_span = tracing.gen_id()
        rctx = {**rctx, "parent_span_id": route_span}
        with tracing.explicit_span(
                "serve.route", trace_id=rctx.get("trace_id", ""),
                span_id=route_span, parent_span_id=parent, kind="route",
                request_id=rctx.get("request_id", ""),
                deployment=self._name):
            return self._remote_impl(args, kwargs, rctx)

    def _remote_impl(self, args, kwargs, request_ctx):
        idx, replica = self._choose(self._model_id, self._prefix_key)
        st = self._router
        mdefs.SERVE_REQUESTS.inc(tags={"deployment": self._name})
        mdefs.SERVE_QUEUE_DEPTH.set(_queue_depth_delta(self._name, +1),
                                    tags={"deployment": self._name})
        start = time.monotonic()

        def _done(_=None):
            with st.lock:
                st.inflight[idx] = max(st.inflight.get(idx, 1) - 1, 0)
            self._observe_done(start)

        if self._stream:
            stream = replica.stream(self._method, args, kwargs,
                                    self._model_id, request_ctx,
                                    on_done=_done)
            return DeploymentResponseGenerator(stream, replica=replica)
        fut = replica.call(self._method, args, kwargs, self._model_id,
                           request_ctx)
        fut.add_done_callback(_done)
        return DeploymentResponse(fut, handle=self, call=(args, kwargs),
                                  replica=replica)


class _HandleMethod:
    def __init__(self, handle: DeploymentHandle, method: str):
        self._handle = handle
        self._method = method

    def remote(self, *args, **kwargs):
        return self._handle.options(self._method).remote(*args, **kwargs)


# ----------------------------------------------------------- deployments
class Application:
    def __init__(self, deployment: "Deployment", args, kwargs):
        self.deployment = deployment
        self.args = args
        self.kwargs = kwargs


class Deployment:
    def __init__(self, cls_or_fn, name: str, num_replicas: int = 1,
                 max_ongoing_requests: int = 100,
                 ray_actor_options: Optional[Dict] = None,
                 autoscaling_config: Optional[Dict[str, Any]] = None,
                 placement_strategy: Optional[str] = None,
                 init_kwargs: Optional[Dict[str, Any]] = None):
        self._cls_or_fn = cls_or_fn
        self.name = name
        self.num_replicas = num_replicas
        self.max_ongoing_requests = max_ongoing_requests
        # ``{"num_gpus": n}`` gives each replica n cards of its own.
        self.ray_actor_options = ray_actor_options or {}
        self.autoscaling_config = autoscaling_config
        self.placement_strategy = placement_strategy
        # Constructor overrides merged over bind() kwargs at deploy time
        # (e.g. the LLM engine's num_slots / sync_every / paged).
        self.init_kwargs = dict(init_kwargs or {})

    def options(self, *, num_replicas: Optional[Any] = None,
                name: Optional[str] = None,
                max_ongoing_requests: Optional[int] = None,
                autoscaling_config: Optional[Dict[str, Any]] = None,
                placement_strategy: Optional[str] = None,
                ray_actor_options: Optional[Dict] = None,
                init_kwargs: Optional[Dict[str, Any]] = None
                ) -> "Deployment":
        return Deployment(
            self._cls_or_fn, name or self.name,
            num_replicas or self.num_replicas,
            max_ongoing_requests or self.max_ongoing_requests,
            ray_actor_options if ray_actor_options is not None
            else self.ray_actor_options,
            autoscaling_config if autoscaling_config is not None
            else self.autoscaling_config,
            placement_strategy or self.placement_strategy,
            init_kwargs if init_kwargs is not None else self.init_kwargs)

    def bind(self, *args, **kwargs) -> Application:
        return Application(self, args, kwargs)


def deployment(_cls=None, *, name: Optional[str] = None,
               num_replicas: Any = 1, max_ongoing_requests: int = 100,
               autoscaling_config: Optional[Dict[str, Any]] = None,
               placement_strategy: Optional[str] = None,
               ray_actor_options: Optional[Dict] = None):
    """``@serve.deployment`` decorator (class or function). The class or
    function must be defined at module level: each replica process
    imports it by name. ``autoscaling_config`` and ``placement_strategy``
    are kept on the record, and :func:`run` refuses them (not ported)."""

    def decorate(cls_or_fn):
        return Deployment(cls_or_fn, name or cls_or_fn.__name__,
                          num_replicas, max_ongoing_requests,
                          ray_actor_options=ray_actor_options,
                          autoscaling_config=autoscaling_config,
                          placement_strategy=placement_strategy)

    if _cls is not None:
        return decorate(_cls)
    return decorate


def _bound_args(dep: Deployment, args, kwargs):
    """bind() args with the deployment's ``init_kwargs`` overrides merged
    over them; a positionally bound argument is rebound by name first,
    so an override retunes it instead of colliding."""
    if not dep.init_kwargs:
        return args, kwargs
    try:
        sig = inspect.signature(dep._cls_or_fn)
    except (TypeError, ValueError):   # C callables etc.
        sig = None
    var_kw = None if sig is None else next(
        (p.name for p in sig.parameters.values()
         if p.kind is inspect.Parameter.VAR_KEYWORD), None)
    if sig is not None and var_kw is None:
        unknown = set(dep.init_kwargs) - set(sig.parameters)
        if unknown:
            raise ValueError(
                f"init_kwargs {sorted(unknown)} not accepted by "
                f"{dep.name}'s constructor")
    try:
        bound = sig.bind_partial(*args, **kwargs)
        for key, value in dep.init_kwargs.items():
            if key in sig.parameters and key != var_kw:
                bound.arguments[key] = value
            else:
                bound.arguments.setdefault(var_kw, {})[key] = value
        return bound.args, dict(bound.kwargs)
    except (TypeError, AttributeError):   # sig None / args mismatch
        return args, {**kwargs, **dep.init_kwargs}


def _is_bound(value) -> bool:
    if isinstance(value, Application):
        return True
    if isinstance(value, (list, tuple)):
        return any(_is_bound(v) for v in value)
    if isinstance(value, dict):
        return any(_is_bound(v) for v in value.values())
    return False


def run(app: Application) -> DeploymentHandle:
    """Deploy ``app`` (its replica processes started and built before
    this returns) and return a handle to it. The ingress routes by the
    deployment's name, so there is no route prefix."""
    dep = app.deployment
    if _is_bound(list(app.args) + list(app.kwargs.values())):
        raise not_ported("deployment graphs (a bound Application as an "
                         "init argument)", _LATER_ITEM)
    if dep.num_replicas == "auto" or dep.autoscaling_config is not None:
        raise not_ported("the serve autoscaler",
                         "item 19 (the autoscaler and the arbiter)")
    if dep.placement_strategy is not None:
        raise not_ported("placement groups (placement_strategy)",
                         _LATER_ITEM)
    args, kwargs = _bound_args(dep, app.args, app.kwargs)
    start().deploy(dep.name, dep._cls_or_fn, args, kwargs,
                   dep.num_replicas, not inspect.isclass(dep._cls_or_fn),
                   dep.max_ongoing_requests, dep.ray_actor_options)
    return DeploymentHandle(dep.name)


def get_deployment_handle(name: str) -> DeploymentHandle:
    return DeploymentHandle(name)


def drain(name: str, count: int = 1) -> int:
    """Gracefully drain ``count`` replicas of deployment ``name`` out of
    rotation (a rolling replace): each drained replica stops admitting,
    leaves the routing table, finishes its in-flight requests up to
    ``RAY_TPU_SERVE_DRAIN_S`` and is replaced by a fresh replica. Returns
    how many drains started."""
    return _get_controller().drain_replicas(name, count, "operator")


def metrics_text() -> str:
    """The Prometheus text of this process's metrics and, with serve
    running, every live replica's samples labelled by replica
    (:meth:`~ray_tpu_torch.runtime.controller.ServeController.metrics_text`;
    the ingress answers ``GET /metrics`` with it)."""
    controller = _controller
    if controller is None:
        return prometheus_text()
    return controller.metrics_text()


def delete(name: str) -> None:
    if _controller is not None:
        _controller.delete(name)


def shutdown() -> None:
    """Stop the HTTP ingress and every replica process, and forget the
    controller."""
    global _controller, _shared_router
    stop_http()
    with _controller_lock:
        controller, _controller = _controller, None
        _shared_router = None
    if controller is not None:
        controller.shutdown()


# ------------------------------------------------------------- data plane
_proxy = None
_shared_router = None


def _router():
    global _shared_router
    if _shared_router is None:
        from ray_tpu_torch.serve.proxy import _Router

        _shared_router = _Router()
    return _shared_router


def start_http(host: str = "127.0.0.1", port: int = 8000) -> int:
    """Start the asyncio HTTP ingress; returns the bound port."""
    global _proxy
    if _proxy is None:
        from ray_tpu_torch.serve.proxy import AsyncHttpProxy

        _proxy = AsyncHttpProxy(host, port, router=_router())
    return _proxy.port


def stop_http() -> None:
    global _proxy
    if _proxy is not None:
        _proxy.stop()
        _proxy = None


def start_grpc(host: str = "127.0.0.1", port: int = 0) -> int:
    raise not_ported("the gRPC ingress (GrpcProxy)", _LATER_ITEM)

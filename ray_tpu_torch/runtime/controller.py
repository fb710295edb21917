"""The serve controller of the port's runtime: the part of
``ServeController`` (``ray_tpu/serve/api.py:366-1207``) that a colocated
deployment needs, as an object in the serving process.

It holds the deployment specs and their replica processes
(:class:`~ray_tpu_torch.runtime.replica.ReplicaProcess`), serves the
routing table to handles (a version per deployment and a callback on
every change, where JAX publishes a route event), and reconciles on a
thread of its own every ``RECONCILE_S``:

* a replica whose process died, or that did not answer a health probe
  within ``HEALTH_TIMEOUT_S``, leaves the routing table and is replaced
  (killed first if it still runs);
* a drain (:meth:`ServeController.drain_replicas`) takes replicas out of
  rotation at once, waits for their in-flight requests up to their
  deadline, retires them and starts their replacements.

A replica that asks for GPUs (``ray_actor_options={"num_gpus": n}``)
gets its cards through ``CUDA_VISIBLE_DEVICES``, the counterpart of
``ray_tpu/_private/node_manager/server.py:1037``: ``n`` cards of its own
for a whole ``n``, or a share of one card for a fraction below 1, as Ray
takes ``num_gpus`` (replicas whose fractions sum to at most 1 share a
card, packed first-fit onto the cards already shared). A deployment that
does not fit the host's cards raises, and a replacement waits for its
share to free.

The controller also carries the chaos plan (:mod:`ray_tpu_torch._private.chaos`)
to its replica processes: it pushes the plan and the firings spent so far
to every replica when either changes, and to every replica it spawns.

It records the serve failure plane as JAX's does: a drain's
``serve.drain_begin`` and ``serve.drain_end`` flight events,
``SERVE_REPLICA_DRAINS`` and ``SERVE_DRAIN_SECONDS``, and each death it
observes in ``SERVE_REPLICA_DEATHS`` (``cause="died"``, or ``"drain"``
for a replica that died draining). :meth:`ServeController.metrics_text`
is the ``GET /metrics`` body: this process's registry with each live
replica's samples, labelled ``replica="<replica_id>"``.

The controller's KV (``kv``: None for a dict of its own, a dict, or a
``torch.distributed`` store such as ``TCPStore``/``FileStore``, as the
checkpoint plane's :class:`~ray_tpu_torch.checkpoint.plane.StoreKV`)
holds ``deployments``: each deployment's replica count, pids and cards,
rewritten on every routing change, and ``role_groups`` (the
disaggregated pairs), so another process can read the serve state. The
autoscaler, the pool arbiter, preemption notices and compact placement
groups are not ported (ROADMAP.md queue A, items 17 and 19).
"""

from __future__ import annotations

import json
import logging
import os
import threading
import time
from concurrent.futures import wait as wait_futures
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
import torch.distributed as dist

from ray_tpu_torch._private import chaos
from ray_tpu_torch._private import events as _events
from ray_tpu_torch._private import metrics_defs as mdefs
from ray_tpu_torch.checkpoint.plane import StoreKV, as_kv
from ray_tpu_torch.runtime.replica import ReplicaProcess
from ray_tpu_torch.util import metrics as _metrics

logger = logging.getLogger(__name__)

SERVE_KV_NS = "__serve__"


def _visible_gpus() -> List[str]:
    """The cards this process may hand out, by the ids its own
    ``CUDA_VISIBLE_DEVICES`` names (all of them when it is unset)."""
    env = os.environ.get("CUDA_VISIBLE_DEVICES")
    if env is not None:
        return [d.strip() for d in env.split(",") if d.strip()]
    return [str(i) for i in range(torch.cuda.device_count())]


# A card's shares may sum to 1 within this slack (0.1 + 0.2 + 0.7).
_SHARE_EPS = 1e-9


def _gpus_per_replica(actor_options: Dict[str, Any]) -> float:
    """A replica's ``num_gpus``: 0, a fraction of one card below 1, or a
    whole number of cards."""
    n = float(actor_options.get("num_gpus") or 0)
    if n < 0 or (n >= 1 and n != int(n)):
        raise ValueError(f"num_gpus={n}: a replica takes a fraction of "
                         f"one GPU below 1, or whole GPUs")
    return int(n) if n >= 1 else n


def _place(use: Dict[str, float], cards: List[str],
           gpus: float) -> Optional[List[str]]:
    """The cards a replica asking ``gpus`` takes given each card's used
    share (``use`` is updated), or None when they are not free. A
    fraction goes to the first card it fits, shared cards first."""
    if gpus >= 1:
        free = [c for c in cards if use.get(c, 0.0) <= _SHARE_EPS]
        if len(free) < gpus:
            return None
        taken = free[:int(gpus)]
        for c in taken:
            use[c] = 1.0
        return taken
    order = sorted(cards, key=lambda c: use.get(c, 0.0) <= _SHARE_EPS)
    for c in order:
        if use.get(c, 0.0) + gpus <= 1.0 + _SHARE_EPS:
            use[c] = use.get(c, 0.0) + gpus
            return [c]
    return None


class ServeController:
    """Reconciles deployment specs into replica processes."""

    REPLICA_START_S = 600.0         # spawn, CUDA, the model's weights
    RECONCILE_S = 0.5
    HEALTH_TIMEOUT_S = 30.0
    DRAIN_GRACE_S = 2.0            # slack past the replica's own deadline
    LOADS_TTL_S = 0.4
    PRESSURE_TTL_S = 0.5

    def __init__(self, kv=None):
        if isinstance(kv, dist.Store):
            kv = StoreKV(kv, SERVE_KV_NS)
        self.kv = as_kv({} if kv is None else kv)
        self.deployments: Dict[str, Dict[str, Any]] = {}
        self.replicas: Dict[str, List[ReplicaProcess]] = {}
        # Replacements still starting, off the routing table until ready.
        self._starting: Dict[str, List[ReplicaProcess]] = {}
        # Draining replicas: name -> [{replica, future, t0, deadline,
        # cause}], out of the routing table but not yet retired.
        self._draining: Dict[str, List[Dict[str, Any]]] = {}
        self._route_version: Dict[str, int] = {}
        self._loads_cache: Dict[str, Any] = {}
        self._pressure_cache: Dict[str, Any] = {}
        self._probes: Dict[int, Any] = {}       # id(replica) -> (t0, future)
        self._cards: Optional[List[str]] = None  # this host's, by id
        self._card_use: Dict[str, float] = {}    # card -> share in use
        # id(replica) -> (its cards, its share of each)
        self._gpu_held: Dict[int, Tuple[List[str], float]] = {}
        self._listeners: List[Callable[[str], None]] = []
        # Logical name -> {"prefill": name, "decode": name}.
        self._role_groups: Dict[str, Dict[str, str]] = {}
        self._lock = threading.RLock()
        self._stop = threading.Event()
        chaos.subscribe(self._push_chaos)
        self._thread = threading.Thread(target=self._reconcile_loop,
                                        daemon=True, name="serve-controller")
        self._thread.start()

    # ------------------------------------------------------------- deploy
    def deploy(self, name: str, cls_or_fn, init_args, init_kwargs,
               num_replicas: int, is_function: bool,
               max_concurrency: int = 100,
               ray_actor_options: Optional[Dict[str, Any]] = None) -> bool:
        """Start ``num_replicas`` replica processes of ``cls_or_fn`` and
        route to them once every one is built; a redeploy of ``name``
        replaces its replicas. A replica that fails to start fails the
        deploy (its error raised, the others stopped): nothing falls back
        to serving in this process."""
        opts = dict(ray_actor_options or {})
        spec = {"cls": cls_or_fn, "args": init_args, "kwargs": init_kwargs,
                "num_replicas": int(num_replicas),
                "is_function": is_function,
                "max_concurrency": max_concurrency, "actor_options": opts,
                "gpus": _gpus_per_replica(opts), "retry_at": 0.0}
        with self._lock:
            # The shares a redeploy frees count as free: the running
            # deployment goes only once the new spec is known to fit.
            use = dict(self._card_use)
            for r in self._replicas_of(name):
                cards, share = self._gpu_held.get(id(r), ([], 0.0))
                for c in cards:
                    use[c] -= share
            busy = sum(use.values())
            if spec["gpus"] and any(
                    _place(use, self._host_cards(), spec["gpus"]) is None
                    for _ in range(spec["num_replicas"])):
                raise ValueError(
                    f"deployment {name!r} asks for {spec['num_replicas']} "
                    f"replicas x {spec['gpus']} GPU(s); this host has "
                    f"{len(self._host_cards())}, {busy:g} of them in use "
                    f"by other deployments")
        self.delete(name)
        with self._lock:
            started = [self._start_replica(name, spec)
                       for _ in range(spec["num_replicas"])]
        try:
            for r in started:
                r.wait_ready(self.REPLICA_START_S)
        except Exception:
            for r in started:
                self._retire(r, kill=True)
            raise
        with self._lock:
            self.deployments[name] = spec
            self.replicas[name] = started
            self._routes_changed(name)
        return True

    def _host_cards(self) -> List[str]:
        if self._cards is None:
            self._cards = _visible_gpus()
        return self._cards

    def _start_replica(self, name: str, spec) -> Optional[ReplicaProcess]:
        """Spawn one replica (None when its share of cards is not free
        yet). It gets the chaos plan before its first request."""
        env = {}
        cards: List[str] = []
        if spec["gpus"]:
            cards = _place(self._card_use, self._host_cards(), spec["gpus"])
            if cards is None:
                return None
            env["CUDA_VISIBLE_DEVICES"] = ",".join(cards)
        replica = ReplicaProcess(
            name, spec["cls"], spec["args"], spec["kwargs"],
            spec["is_function"], sync_workers=spec["max_concurrency"],
            env=env,
            num_threads=int(spec["actor_options"].get("num_cpus", 1) or 1))
        replica.push_chaos(chaos.state())
        if cards:
            self._gpu_held[id(replica)] = (
                cards, 1.0 if spec["gpus"] >= 1 else spec["gpus"])
        return replica

    def _retire(self, replica: ReplicaProcess, kill: bool = False) -> None:
        """Stop a replica (SIGKILL with ``kill``) and free its cards."""
        if kill:
            replica.kill()
        else:
            replica.stop()
        with self._lock:
            self._probes.pop(id(replica), None)
            cards, share = self._gpu_held.pop(id(replica), ([], 0.0))
            for c in cards:
                self._card_use[c] = max(self._card_use[c] - share, 0.0)

    def _push_chaos(self) -> None:
        """The chaos plan or its firings changed: every replica process
        gets the new state."""
        shared = chaos.state()
        with self._lock:
            replicas = [r for name in set(self.deployments) | set(
                self._starting) | set(self._draining)
                for r in self._replicas_of(name)]
        for r in replicas:
            r.push_chaos(shared)

    def _replicas_of(self, name: str) -> List[ReplicaProcess]:
        """Every replica process of ``name``: routed, starting, draining."""
        return (self.replicas.get(name, []) + self._starting.get(name, [])
                + [e["replica"] for e in self._draining.get(name, [])])

    def delete(self, name: str) -> bool:
        with self._lock:
            doomed = self._replicas_of(name)
            spec = self.deployments.pop(name, None)
            for table in (self.replicas, self._starting, self._draining):
                table.pop(name, None)
            if spec is not None:
                self._routes_changed(name)
        for r in doomed:
            self._retire(r, kill=True)
        return spec is not None

    def shutdown(self) -> None:
        chaos.unsubscribe(self._push_chaos)
        self._stop.set()
        self._thread.join(timeout=10)
        for name in list(self.deployments):
            self.delete(name)

    # -------------------------------------------------------- role groups
    def set_role_group(self, name: str, group: Dict[str, str]) -> None:
        with self._lock:
            self._role_groups[name] = dict(group)
            self._write_role_groups()

    def get_role_group(self, name: str) -> Optional[Dict[str, str]]:
        with self._lock:
            group = self._role_groups.get(name)
            return dict(group) if group else None

    def delete_role_group(self, name: str) -> bool:
        with self._lock:
            found = self._role_groups.pop(name, None) is not None
            self._write_role_groups()
            return found

    def _write_role_groups(self) -> None:
        self.kv.put("role_groups", json.dumps(self._role_groups).encode())

    # ------------------------------------------------------------- routes
    def subscribe(self, callback: Callable[[str], None]) -> None:
        """``callback(name)`` runs whenever ``name``'s routing table
        changes (JAX's route-change event)."""
        with self._lock:
            self._listeners.append(callback)

    def _routes_changed(self, name: str) -> None:
        """A new routing table version: the loads and pressure caches are
        aligned with the old table, so they go; listeners hear of it and
        the KV's record is rewritten."""
        self._loads_cache.pop(name, None)
        self._pressure_cache.pop(name, None)
        self._route_version[name] = self._route_version.get(name, 0) + 1
        for cb in list(self._listeners):
            try:
                cb(name)
            except Exception:  # noqa: BLE001 — one bad listener only
                logger.exception("route listener failed")
        record = {n: {"num_replicas": s["num_replicas"],
                      "replicas": [{"pid": r.pid,
                                    "cards": self._gpu_held.get(
                                        id(r), ([], 0.0))[0]}
                                   for r in self.replicas.get(n, [])]}
                  for n, s in self.deployments.items()}
        self.kv.put("deployments", json.dumps(record).encode())

    def get_replicas(self, name: str) -> List[ReplicaProcess]:
        with self._lock:
            return list(self.replicas.get(name, []))

    def get_routes(self, name: str):
        """(version, replicas): the versioned routing table, without the
        replicas already seen dead (reconcile replaces them)."""
        with self._lock:
            return (self._route_version.get(name, 0),
                    [r for r in self.replicas.get(name, []) if not r.dead])

    def list_deployments(self) -> Dict[str, Dict[str, Any]]:
        with self._lock:
            return {name: {"num_replicas": spec["num_replicas"]}
                    for name, spec in self.deployments.items()}

    def _fan_out(self, name: str, op: str, cache: Dict[str, Any],
                 ttl: float, missing, read):
        """One control call to every routed replica under one shared
        1-second deadline (a dying replica must not stall the others),
        aligned with ``get_routes`` order and TTL-cached."""
        now = time.monotonic()
        cached = cache.get(name)
        if cached is not None and now - cached[0] < ttl:
            return cached[1]
        replicas = self.get_replicas(name)
        futs = [r.control(op) for r in replicas]
        wait_futures(futs, timeout=1.0)
        out = [missing(i) for i in range(len(futs))]
        for i, f in enumerate(futs):
            if f.done() and f.exception() is None:
                out[i] = read(i, f.result())
        cache[name] = (now, out)
        return out

    def get_replica_loads(self, name: str) -> List[int]:
        """Per-replica ongoing-request counts (a silent replica reads as
        loaded, so the router avoids it)."""
        return self._fan_out(name, "metrics", self._loads_cache,
                             self.LOADS_TTL_S, lambda i: 1 << 20,
                             lambda i, m: m["ongoing"])

    def get_replica_pressure(self, name: str) -> List[Dict[str, Any]]:
        """Per-replica pressure snapshots (the prefix-affinity router and
        the ingress admission gate read these)."""
        return self._fan_out(
            name, "pressure", self._pressure_cache, self.PRESSURE_TTL_S,
            lambda i: {"replica": i, "unreachable": True},
            lambda i, snap: {"replica": i, **(snap or {})})

    # ------------------------------------------------------------ metrics
    def metrics_text(self, timeout_s: float = 2.0) -> str:
        """The ``GET /metrics`` body: this process's registry rendered
        as ``prometheus_text`` renders it, each metric family followed
        by every live replica's samples of it (``collect_samples``:
        counters and gauges, a histogram's ``_count`` and ``_sum``),
        each labelled ``replica="<replica_id>"``; families only replicas
        have come last, untyped. Replicas that do not answer within
        ``timeout_s`` are left out.

        The rule for a respawn: only live replicas are asked, and a
        replica id names one process, never reused. A dead replica's
        samples leave the text with it and its replacement's series
        start at zero under a new label, so nothing is counted twice
        and no series seems to reset."""
        with self._lock:
            replicas = [r for name in set(self.deployments) | set(
                self._draining) for r in self._replicas_of(name)
                if r.alive and r.ready]
        futs = [(r, r.control("samples")) for r in replicas]
        wait_futures([f for _, f in futs], timeout=timeout_s)
        extra: Dict[str, List[str]] = {}
        for r, f in futs:
            if not f.done() or f.exception() is not None:
                continue
            label = (("replica", r.replica_id),)
            for sname, key, value in f.result():
                labels = ",".join(f'{k}="{v}"'
                                  for k, v in tuple(key) + label)
                extra.setdefault(sname, []).append(
                    f"{sname}{{{labels}}} {value}")
        lines: List[str] = []
        for m in _metrics.all_metrics():
            lines.extend(m.render())
            names = ([m.name + "_count", m.name + "_sum"]
                     if isinstance(m, _metrics.Histogram) else [m.name])
            for n in names:
                lines.extend(extra.pop(n, ()))
        for sname, rows in extra.items():
            lines.append(f"# TYPE {sname} untyped")
            lines.extend(rows)
        return "\n".join(lines) + "\n"

    # -------------------------------------------------------------- drain
    def drain_replicas(self, name: str, count: int = 1,
                       cause: str = "operator") -> int:
        """Drain ``count`` replicas of ``name`` out of rotation without
        shrinking the spec: each stops admitting, finishes its in-flight
        requests up to ``RAY_TPU_SERVE_DRAIN_S`` and is retired, and
        reconcile starts its replacement (a rolling replace). Returns how
        many drains started."""
        deadline_s = float(os.environ.get("RAY_TPU_SERVE_DRAIN_S", "30"))
        started = 0
        with self._lock:
            current = list(self.replicas.get(name, []))
            while current and started < count:
                victim = current.pop()
                now = time.monotonic()
                self._draining.setdefault(name, []).append({
                    "replica": victim, "cause": cause, "t0": now,
                    "deadline": now + deadline_s,
                    "future": victim.control("drain", deadline_s),
                    "event_id": _events.emit(
                        "serve.drain_begin", subject={
                            "deployment": name,
                            "replica": victim.replica_id},
                        drain_cause=cause, deadline_s=deadline_s)})
                mdefs.SERVE_REPLICA_DRAINS.inc(
                    tags={"deployment": name, "cause": cause})
                started += 1
            if started:
                self.replicas[name] = current
                self._routes_changed(name)
        return started

    def draining_count(self, name: str) -> int:
        with self._lock:
            return len(self._draining.get(name, []))

    def _advance_drains(self, name: str) -> None:
        """Retire the replicas whose drain answered (drained or past its
        own deadline), died, or outlived its deadline and grace."""
        now = time.monotonic()
        with self._lock:
            entries = self._draining.get(name, [])
            done = [e for e in entries
                    if e["future"].done() or not e["replica"].alive
                    or now > e["deadline"] + self.DRAIN_GRACE_S]
            self._draining[name] = [e for e in entries if e not in done]
            if not self._draining[name]:
                del self._draining[name]
        for e in done:
            fut = e["future"]
            res = (fut.result() if fut.done() and fut.exception() is None
                   else None)
            if res is not None:
                outcome = "drained" if res.get("drained") else "deadline"
            elif fut.done() or not e["replica"].alive:
                outcome = "died"
            else:
                outcome = "deadline"
            mdefs.SERVE_DRAIN_SECONDS.observe(
                now - e["t0"], tags={"deployment": name,
                                     "outcome": outcome})
            _events.emit("serve.drain_end", cause=e["event_id"],
                         subject={"deployment": name,
                                  "replica": e["replica"].replica_id},
                         outcome=outcome, drain_cause=e["cause"],
                         waited_s=now - e["t0"])
            if outcome == "died":
                mdefs.SERVE_REPLICA_DEATHS.inc(
                    tags={"deployment": name, "cause": "drain"})
            logger.info("serve: drain of a %s replica (%s) ended after "
                        "%.2f s: %s", name, e["cause"], now - e["t0"],
                        outcome)
            self._retire(e["replica"])

    # ---------------------------------------------------------- reconcile
    def _reconcile_loop(self) -> None:
        while not self._stop.wait(self.RECONCILE_S):
            with self._lock:
                names = set(self.deployments) | set(self._draining)
            for name in names:
                try:
                    self._advance_drains(name)
                    self._reconcile_once(name)
                except Exception:  # noqa: BLE001 — keep reconciling
                    logger.exception("serve: reconcile of %s failed", name)

    def _healthy(self, r: ReplicaProcess, now: float) -> bool:
        """Alive, and its last health probe answered within
        HEALTH_TIMEOUT_S (a probe is sent each pass when none waits)."""
        if not r.alive:
            return False
        t0, fut = self._probes.get(id(r), (now, None))
        if fut is not None and not fut.done():
            return now - t0 < self.HEALTH_TIMEOUT_S
        self._probes[id(r)] = (now, r.control("health"))
        return True

    def _reconcile_once(self, name: str) -> None:
        now = time.monotonic()
        with self._lock:
            spec = self.deployments.get(name)
            if spec is None:
                return
            current = self.replicas.get(name, [])
            live = [r for r in current if self._healthy(r, now)]
            lost = [r for r in current if r not in live]
            for r in lost:          # their cards free for the replacements
                logger.warning("serve: a replica of %s (pid %s) died or "
                               "hung; replacing it", name, r.pid)
                mdefs.SERVE_REPLICA_DEATHS.inc(
                    tags={"deployment": name, "cause": "died"})
                self._retire(r, kill=True)
            starting = self._starting.get(name, [])
            ready = [r for r in starting if r.ready]
            failed = [r for r in starting if r.ready is False]
            self._starting[name] = [r for r in starting if r.ready is None]
            live += ready
            while (len(live) + len(self._starting[name])
                   < spec["num_replicas"] and now >= spec["retry_at"]):
                r = self._start_replica(name, spec)
                if r is None:
                    break             # its cards are still held
                self._starting[name].append(r)
            if lost or ready:
                self.replicas[name] = live
                self._routes_changed(name)
        for r in failed:
            try:
                r.wait_ready(0)
            except Exception:  # noqa: BLE001 — logged; retried in 5 s
                logger.exception("serve: a replacement replica of %s "
                                 "failed to start", name)
            spec["retry_at"] = time.monotonic() + 5.0
            self._retire(r, kill=True)

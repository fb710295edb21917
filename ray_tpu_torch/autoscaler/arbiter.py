"""Card-pool arbiter: crash-safe serve<->train card handoffs (the port of
``ray_tpu/autoscaler/arbiter.py``).

Cards are the scarce resource and two live workloads share them: the
serve fleet (replicas, each owning ``chips_per_replica``) and the elastic
trainer (workers, each owning ``chips_per_worker``). The arbiter closes
the diurnal loop: serve sheds replicas at night, training grows its
group to absorb the freed cards, and the handoff reverses under morning
load, with the handoff itself surviving preemption, replica death and an
arbiter crash mid-flight. The pool counts cards, or fractions of one
where the replicas ask for fractions (a count is kept as an int when it
is whole, so a journal of whole counts is JAX's byte for byte); the
journal's field is still named ``chips``, as JAX's is.

Ledger model
============

The pool has a fixed ``total`` and a journaled ``base`` split (``config``
key). Every movement is a **lease**: a journaled record that walks an
explicit state machine::

    PENDING -> FREEING -> FREED -> GRANTING -> COMMITTED
                  |          |        |
                  +----------+--------+--> ABORTING -> ABORTED
    COMMITTED -> RETURN_FREEING -> RETURN_GRANTING -> RETURNED

* ``FREEING``: the donor is releasing cards (serve: the controller's
  graceful drain of victim replicas; train: a ``world_target`` shrink
  ask on the preemption channel).
* ``FREED``: the donor confirmed the cards are free.
* ``GRANTING``: the recipient is absorbing (train: a grown
  ``world_target`` latched by the trainer's ResizeGuard; serve: replicas
  spawned).
* ``COMMITTED``: the recipient confirmed (the group re-formed at the
  leased world, or the replicas routed); the lease is live and carries a
  **deadline** whose expiry returns the cards to the donor.
* ``RETURN_*``: the reverse handoff (deadline expiry or SLO reversal).
* ``ABORTING``/``ABORTED``: rollback before commit.

**Conservation is structural**: each lease contributes a pure per-stage
delta to the derived allocation (transitional stages hold the cards
``in_flight``; COMMITTED credits the recipient; terminal stages net
zero), so ``serve + train + in_flight == total`` on every tick by
construction, and :meth:`PoolLedger.verify` asserts it plus
non-negativity.

**Crash safety**: every transition goes through one journaled helper
(:meth:`PoolLedger._journal_put`; ``tests/test_torch_pool_arbiter.py``
lints this); a restarted arbiter reloads the journal, re-issues the
recorded absolute targets for the stage each lease was parked in (the
side effects, ``pool_set_replicas`` and ``request_resize``, are
idempotent), and resumes or rolls back. Stages that stop converging past
``RAY_TPU_POOL_STAGE_TIMEOUT_S`` roll back rather than wedge.

**SLO guard**: while the serve plane's shed rate or TTFT/latency p95
regress, the arbiter refuses to take serve cards (PENDING serve-donor
leases abort) and reverses the newest committed serve->train lease; the
reversal is journaled under ``last_reversal``.

The port's journal is the process's ``internal_kv`` (namespace
``__pool__``; :class:`InternalKv`), the local mode of JAX's. The serve
side is the in-process controller (``serve.api._get_controller()``),
where JAX calls the controller actor; the train side reads the world
record the trainer writes to the same ``internal_kv``, which is the GCS
KV when the process is connected to a cluster. :class:`GrpcKv` and
``read_pool_state(gcs_address=...)`` go straight to a GCS's KV over the
port's wire, no runtime needed, as JAX's do over gRPC.

Chaos sites (:mod:`ray_tpu_torch._private.chaos`): ``pool_tick``
(``kill_arbiter``) fires at the top of :meth:`ChipPoolArbiter.tick`;
``pool_handoff`` (``preempt_node``) fires before every lease advance,
matchable on ``stage=``.
"""

from __future__ import annotations

import json
import logging
import os
import threading
import time
import uuid
from typing import Any, Dict, List, Optional, Tuple

from ray_tpu_torch._private import events as _events

logger = logging.getLogger(__name__)

POOL_KV_NS = "__pool__"

# Lease stages.
PENDING = "PENDING"                  # journaled intent, nothing moved yet
FREEING = "FREEING"                  # donor releasing (drain / shrink ask)
FREED = "FREED"                      # donor confirmed cards free
GRANTING = "GRANTING"                # recipient absorbing (grow / spawn)
COMMITTED = "COMMITTED"              # recipient confirmed; deadline armed
RETURN_FREEING = "RETURN_FREEING"    # recipient giving the cards back
RETURN_GRANTING = "RETURN_GRANTING"  # donor re-absorbing
RETURNED = "RETURNED"                # terminal: cards back at the donor
ABORTING = "ABORTING"                # rollback before commit
ABORTED = "ABORTED"                  # terminal: rollback complete

_LEASE_TRANSITIONS = {
    PENDING: {FREEING, ABORTING, ABORTED},
    FREEING: {FREED, ABORTING},
    FREED: {GRANTING, ABORTING},
    GRANTING: {COMMITTED, ABORTING},
    COMMITTED: {RETURN_FREEING},
    RETURN_FREEING: {RETURN_GRANTING},
    RETURN_GRANTING: {RETURNED},
    ABORTING: {ABORTED},
    RETURNED: set(),
    ABORTED: set(),
}

TERMINAL = frozenset({RETURNED, ABORTED})
TRANSITIONAL = frozenset({FREEING, FREED, GRANTING, ABORTING,
                          RETURN_FREEING, RETURN_GRANTING})

# Slack for a count of fractional units (0.25 + 0.5 + 0.25).
_EPS = 1e-9


class InvalidLeaseTransition(RuntimeError):
    pass


def _units(x) -> float:
    """A card count as the journal keeps it: an int when it is whole
    (JAX's records), else the fraction."""
    x = float(x)
    return int(round(x)) if abs(x - round(x)) < _EPS else x


def _per(count: float, per: float) -> int:
    """How many holders of ``per`` units fit ``count`` units."""
    return max(int(float(count) / per + _EPS), 0)


def _stage_delta(stage: str, chips: float) -> Tuple[float, float, float]:
    """(d_donor, d_recipient, d_in_flight) a lease contributes to the
    derived allocation: a pure function of its stage, so the ledger's
    accounting is replayable from the journal alone."""
    if stage in TRANSITIONAL:
        return -chips, 0, chips
    if stage == COMMITTED:
        return -chips, chips, 0
    return 0, 0, 0  # PENDING / RETURNED / ABORTED


def compute_allocation(config: Dict[str, Any],
                       leases: List[Dict[str, Any]]) -> Dict[str, float]:
    """Derived allocation: base split plus every lease's stage delta (the
    live arbiter and :func:`read_pool_state` agree by construction)."""
    alloc = {"serve": _units(config["base"]["serve"]),
             "train": _units(config["base"]["train"]), "in_flight": 0}
    for lease in leases:
        d_donor, d_recip, d_infl = _stage_delta(lease["stage"],
                                                _units(lease["chips"]))
        alloc[lease["donor"]] += d_donor
        alloc[lease["recipient"]] += d_recip
        alloc["in_flight"] += d_infl
    alloc = {k: _units(v) for k, v in alloc.items()}
    alloc["total"] = _units(config["total"])
    return alloc


# --------------------------------------------------------------- KV stores
class DictKv:
    """In-memory KV with the journal surface: unit tests replay truncated
    journals through it without a runtime."""

    def __init__(self, data: Optional[Dict[str, bytes]] = None):
        self.data: Dict[str, bytes] = dict(data or {})

    def get(self, key: str) -> Optional[bytes]:
        return self.data.get(key)

    def put(self, key: str, value: bytes) -> None:
        self.data[key] = bytes(value)

    def delete(self, key: str) -> None:
        self.data.pop(key, None)

    def keys(self, prefix: str = "") -> List[str]:
        return [k for k in self.data if k.startswith(prefix)]


class InternalKv:
    """The process's ``internal_kv`` namespace ``__pool__`` (the local
    mode of JAX's GCS KV)."""

    def __init__(self, namespace: str = POOL_KV_NS):
        self.namespace = namespace

    def get(self, key: str) -> Optional[bytes]:
        from ray_tpu_torch.experimental import internal_kv as kv

        return kv.internal_kv_get(key, namespace=self.namespace)

    def put(self, key: str, value: bytes) -> None:
        from ray_tpu_torch.experimental import internal_kv as kv

        kv.internal_kv_put(key, value, overwrite=True,
                           namespace=self.namespace)

    def delete(self, key: str) -> None:
        from ray_tpu_torch.experimental import internal_kv as kv

        kv.internal_kv_del(key, namespace=self.namespace)

    def keys(self, prefix: str = "") -> List[str]:
        from ray_tpu_torch.experimental import internal_kv as kv

        return kv.internal_kv_list(prefix, namespace=self.namespace)


class GrpcKv:
    """The ``__pool__`` namespace of a GCS's KV, over the port's wire (JAX's
    name; its transport is gRPC): a PoolLedger journaling straight against
    a GCS's Kv handlers, no runtime required."""

    def __init__(self, address: str, namespace: str = POOL_KV_NS):
        from ray_tpu_torch._private import rpc

        self.namespace = namespace
        self._stub = rpc.get_stub("GcsService", address)

    def get(self, key: str) -> Optional[bytes]:
        from ray_tpu_torch._private import messages as pb

        reply = self._stub.KvGet(pb.KvRequest(ns=self.namespace, key=key))
        return bytes(reply.value) if reply.found else None

    def put(self, key: str, value: bytes) -> None:
        from ray_tpu_torch._private import messages as pb

        self._stub.KvPut(pb.KvRequest(ns=self.namespace, key=key,
                                      value=bytes(value), overwrite=True))

    def delete(self, key: str) -> None:
        from ray_tpu_torch._private import messages as pb

        self._stub.KvDel(pb.KvRequest(ns=self.namespace, key=key))

    def keys(self, prefix: str = "") -> List[str]:
        from ray_tpu_torch._private import messages as pb

        return list(self._stub.KvKeys(pb.KvRequest(
            ns=self.namespace, prefix=prefix)).keys)


# ----------------------------------------------------------------- ledger
class PoolLedger:
    """Journaled lease table over a KV store.

    Every write goes through :meth:`_journal_put` / :meth:`_journal_del`,
    the only writers (a source lint in the tests pins this), so no
    transition can bypass the journal."""

    MAX_TERMINAL_KEPT = 256
    MAX_HISTORY = 64

    def __init__(self, kv=None):
        self.kv = kv if kv is not None else InternalKv()

    # ----------------------------------------------------- journal I/O
    def _journal_put(self, key: str, record: Dict[str, Any]) -> None:
        """The ledger write: one key, one JSON record. Every config,
        lease and reversal mutation funnels here."""
        self.kv.put(key, json.dumps(record, sort_keys=True).encode())

    def _journal_del(self, key: str) -> None:
        """The ledger delete (terminal-lease pruning only)."""
        self.kv.delete(key)

    def _read(self, key: str) -> Optional[Dict[str, Any]]:
        raw = self.kv.get(key)
        if raw is None:
            return None
        try:
            return json.loads(raw)
        except ValueError:  # a torn record reads as absent, loudly
            logger.error("pool ledger: unreadable record %r", key)
            return None

    # ----------------------------------------------------------- state
    def config(self) -> Optional[Dict[str, Any]]:
        return self._read("config")

    def bootstrap(self, serve_chips: float, train_chips: float,
                  meta: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
        """Journal the pool's base split once; an existing config wins (a
        restarted arbiter must not re-baseline over live leases)."""
        cfg = self.config()
        if cfg is not None:
            return cfg
        cfg = {"total": _units(float(serve_chips) + float(train_chips)),
               "base": {"serve": _units(serve_chips),
                        "train": _units(train_chips)},
               "ts": time.time(), **(meta or {})}
        self._journal_put("config", cfg)
        return cfg

    def leases(self, stages: Optional[frozenset] = None
               ) -> List[Dict[str, Any]]:
        out = []
        for key in sorted(self.kv.keys("lease/")):
            rec = self._read(key)
            if rec is None:
                continue
            if stages is None or rec["stage"] in stages:
                out.append(rec)
        return out

    def get_lease(self, lease_id: str) -> Optional[Dict[str, Any]]:
        return self._read(f"lease/{lease_id}")

    def create_lease(self, donor: str, recipient: str, chips: float,
                     lease_s: float) -> Dict[str, Any]:
        if donor == recipient or {donor, recipient} - {"serve", "train"}:
            raise ValueError(f"bad handoff {donor}->{recipient}")
        if chips <= 0:
            raise ValueError(f"bad chip count {chips}")
        now = time.time()
        lease = {
            "lease_id": f"lease-{uuid.uuid4().hex[:12]}",
            "donor": donor, "recipient": recipient, "chips": _units(chips),
            "stage": PENDING, "created_ts": now,
            "lease_s": float(lease_s), "deadline_ts": None,
            "history": [[PENDING, now, "created"]],
        }
        self._journal_put(f"lease/{lease['lease_id']}", lease)
        _events.emit("pool.lease", subject={"lease_id": lease["lease_id"]},
                     stage=PENDING, detail="created", donor=donor,
                     recipient=recipient, chips=lease["chips"])
        return lease

    def advance(self, lease: Dict[str, Any], stage: str,
                detail: str = "", cause_event: str = "",
                **fields: Any) -> Dict[str, Any]:
        """Validated, journaled transition (plus recorded fields, e.g. the
        absolute targets a restarted arbiter re-issues). ``cause_event``
        links the flight record of this transition to the event that
        forced it (an SLO breach, a preemption notice)."""
        if stage not in _LEASE_TRANSITIONS.get(lease["stage"], set()):
            raise InvalidLeaseTransition(
                f"lease {lease['lease_id']}: {lease['stage']} -> {stage}")
        lease = dict(lease, stage=stage, **fields)
        hist = list(lease["history"])[-self.MAX_HISTORY + 1:]
        hist.append([stage, time.time(), detail])
        lease["history"] = hist
        self._journal_put(f"lease/{lease['lease_id']}", lease)
        _events.emit("pool.lease", cause=cause_event,
                     subject={"lease_id": lease["lease_id"]},
                     stage=stage, detail=detail, donor=lease["donor"],
                     recipient=lease["recipient"], chips=lease["chips"])
        if stage in TERMINAL:
            self._prune()
        return lease

    def record_reversal(self, lease: Dict[str, Any], action: str,
                        signal: str, detail: str = "",
                        cause_event: str = "") -> str:
        self._journal_put("last_reversal", {
            "lease_id": lease["lease_id"], "action": action,
            "signal": signal, "detail": detail, "ts": time.time(),
            "chips": lease["chips"],
            "direction": f"{lease['donor']}_to_{lease['recipient']}"})
        return _events.emit(
            "pool.reversal", cause=cause_event,
            subject={"lease_id": lease["lease_id"]},
            action=action, signal=signal, detail=detail)

    def last_reversal(self) -> Optional[Dict[str, Any]]:
        return self._read("last_reversal")

    def _prune(self) -> None:
        terminal = self.leases(TERMINAL)
        excess = len(terminal) - self.MAX_TERMINAL_KEPT
        if excess > 0:
            terminal.sort(key=lambda r: r["history"][-1][1])
            for rec in terminal[:excess]:
                self._journal_del(f"lease/{rec['lease_id']}")

    # ------------------------------------------------------- invariants
    def allocation(self, leases: Optional[List[Dict[str, Any]]] = None
                   ) -> Dict[str, float]:
        """Derived allocation; pass an already-read ``leases`` snapshot to
        avoid re-scanning the journal."""
        cfg = self.config()
        if cfg is None:
            return {"serve": 0, "train": 0, "in_flight": 0, "total": 0}
        return compute_allocation(
            cfg, self.leases() if leases is None else leases)

    def verify(self, leases: Optional[List[Dict[str, Any]]] = None
               ) -> List[str]:
        """The conservation invariant: every card in exactly one ledger
        state, none leased to two owners, none orphaned. Returns
        human-readable violations (empty = healthy)."""
        cfg = self.config()
        if cfg is None:
            return []
        if leases is None:
            leases = self.leases()
        violations = []
        alloc = compute_allocation(cfg, leases)
        for owner in ("serve", "train", "in_flight"):
            if alloc[owner] < -_EPS:
                violations.append(
                    f"negative_share: {owner}={alloc[owner]} "
                    f"(a chip is leased to two owners)")
        booked = alloc["serve"] + alloc["train"] + alloc["in_flight"]
        if abs(booked - alloc["total"]) > _EPS:
            violations.append(
                f"total_mismatch: serve+train+in_flight={_units(booked)} != "
                f"total={alloc['total']} (orphaned chips)")
        for lease in leases:
            if lease["chips"] <= 0:
                violations.append(
                    f"empty_lease: {lease['lease_id']}")
            if lease["stage"] not in _LEASE_TRANSITIONS:
                violations.append(
                    f"unknown_stage: {lease['lease_id']} "
                    f"{lease['stage']}")
        return violations


# ------------------------------------------------------ workload adapters
class ServeWorkload:
    """The serve fleet's side of a handoff, over the controller's pool
    surface (``pool_set_replicas`` / ``pool_state``): shrink = graceful
    drain of victims, grow = replica spawn, and a cap that stops the
    pressure autoscaler re-growing into cards leased away. The controller
    is this process's (``serve.api._get_controller()``); JAX calls its
    controller actor."""

    kind = "serve"

    def __init__(self, deployment: str, chips_per_replica: float = 1,
                 min_chips: Optional[float] = None):
        self.deployment = deployment
        self.cpr = float(chips_per_replica)
        if self.cpr <= 0:
            raise ValueError(f"chips_per_replica={chips_per_replica}")
        self.min_chips = _units(min_chips if min_chips is not None
                                else self.cpr)

    def _controller(self):
        from ray_tpu_torch.serve import api as serve_api

        return serve_api._get_controller()

    def _state(self) -> Dict[str, Any]:
        return self._controller().pool_state(self.deployment)

    def chips(self) -> float:
        return _units(self._state()["routed"] * self.cpr)

    def target_chips(self) -> float:
        return _units(self._state()["target"] * self.cpr)

    def set_chips(self, chips: float, cause: str,
                  capped: bool = True) -> None:
        replicas = _per(chips, self.cpr)
        self._controller().pool_set_replicas(
            self.deployment, replicas,
            cap=replicas if capped else None, cause=cause)

    def clear_cap(self) -> None:
        """Lease fully unwound: give the pressure autoscaler its ceiling
        back (the current target again, with no cap)."""
        st = self._state()
        self._controller().pool_set_replicas(
            self.deployment, st["target"], cap=None, cause="pool-uncap")

    def settled(self, chips: float) -> bool:
        """The lease moves entitlement (the cap); replica use within it
        stays the serve plane's. Settled when the cap is in force, the
        controller routes its own (possibly autoscaled, cap-bounded)
        target, and no drain is still finishing in-flight work."""
        st = self._state()
        want = _per(chips, self.cpr)
        if st["cap"] != want:
            return False
        return st["draining"] == 0 and st["routed"] == st["target"] and \
            st["target"] <= want

    def pressure(self) -> Dict[str, float]:
        """Summed router and engine pressure, for the diurnal policy."""
        snaps = self._controller().get_replica_pressure(self.deployment)
        ongoing = queue = 0.0
        for s in snaps or []:
            if not s or s.get("unreachable"):
                continue
            ongoing += float(s.get("ongoing") or 0)
            queue += float(s.get("queue_depth") or 0)
        return {"ongoing": ongoing, "queue": queue,
                "replicas": len(snaps or [])}


class TrainWorkload:
    """The elastic trainer's side of a handoff: grow and shrink asks ride
    the preemption channel as ``world_target`` hints latched by the
    trainer's ResizeGuard; confirmation reads the ``world/<run>`` record
    the trainer writes to ``internal_kv`` (``__train__``) when each
    attempt's group forms."""

    kind = "train"

    def __init__(self, run_name: str, chips_per_worker: float = 1,
                 min_chips: Optional[float] = None):
        self.run = run_name
        self.cpw = float(chips_per_worker)
        if self.cpw <= 0:
            raise ValueError(f"chips_per_worker={chips_per_worker}")
        self.min_chips = _units(min_chips if min_chips is not None
                                else self.cpw)

    def world(self) -> int:
        from ray_tpu_torch.experimental import internal_kv as kv
        from ray_tpu_torch.train.backend_executor import TRAIN_KV_NS

        raw = kv.internal_kv_get(f"world/{self.run}",
                                 namespace=TRAIN_KV_NS)
        if raw is None:
            return 0
        try:
            rec = json.loads(raw)
        except ValueError:
            return 0
        if rec.get("run_ended"):
            return 0
        return int(rec.get("world", 0))

    def chips(self) -> float:
        return _units(self.world() * self.cpw)

    def target_chips(self) -> float:
        # Outside an attempt the trainer has no standing target: the
        # formed world is the target.
        return self.chips()

    def set_chips(self, chips: float, cause: str,
                  capped: bool = True) -> None:
        from ray_tpu_torch.train import elastic

        elastic.request_resize(max(_per(chips, self.cpw), 1),
                               reason=f"pool-{cause}")

    def clear_cap(self) -> None:
        pass  # the trainer's ceiling is the ask itself

    def settled(self, chips: float) -> bool:
        return self.world() == max(_per(chips, self.cpw), 1)


# -------------------------------------------------------------- SLO guard
class SloGuard:
    """The serve-SLO watchdog the arbiter consults every tick:
    between-tick deltas of the ingress shed counters and the TTFT and
    router-latency histograms of one deployment, read from this process's
    registry. A breach means "do not take serve cards now, and give back
    what the serve plane recently donated"."""

    def __init__(self, deployment: str,
                 shed_rate: Optional[float] = None,
                 ttft_p95_s: Optional[float] = None,
                 latency_p95_s: Optional[float] = None,
                 min_samples: Optional[int] = None):
        self.deployment = deployment
        self.shed_rate = (shed_rate if shed_rate is not None
                          else _envf("RAY_TPU_POOL_SLO_SHED_RATE", "0.05"))
        self.ttft_p95_s = (ttft_p95_s if ttft_p95_s is not None
                           else _envf("RAY_TPU_POOL_SLO_TTFT_P95_S", "0"))
        self.latency_p95_s = (
            latency_p95_s if latency_p95_s is not None
            else _envf("RAY_TPU_POOL_SLO_LATENCY_P95_S", "0"))
        self.min_samples = int(
            min_samples if min_samples is not None
            else _envf("RAY_TPU_POOL_SLO_MIN_SAMPLES", "5"))
        self._prev_shed = self._prev_total = 0.0
        self._prev_buckets: Dict[str, List[int]] = {}
        self._primed = False

    def _counters(self) -> Tuple[float, float]:
        """(sheds, sheds + routed): sheds never route, so the routed
        requests are exactly the admitted rest."""
        from ray_tpu_torch._private import metrics_defs as mdefs

        shed = mdefs.serve_shed_total(self.deployment)
        routed = 0.0
        for _n, key, v in mdefs.SERVE_REQUESTS.samples():
            if dict(key).get("deployment") == self.deployment:
                routed += v
        return shed, shed + routed

    def _p95_window(self, name: str, hist) -> Optional[float]:
        bounds, counts, _total = hist.bucket_snapshot(
            {"deployment": self.deployment})
        prev = self._prev_buckets.get(name, [0] * len(counts))
        window = [max(c - p, 0) for c, p in zip(counts, prev)]
        self._prev_buckets[name] = counts
        if sum(window) < self.min_samples:
            return None
        return hist.percentile_from(bounds, window, 0.95)

    def check(self) -> Optional[Dict[str, Any]]:
        """One windowed evaluation; the first call only primes the
        cursors (lifetime counters must not read as a fresh regression).
        Returns ``{"signal", "value", "threshold"}`` on a breach."""
        from ray_tpu_torch._private import metrics_defs as mdefs

        shed, total = self._counters()
        d_shed = shed - self._prev_shed
        d_total = total - self._prev_total
        self._prev_shed, self._prev_total = shed, total
        ttft_p95 = (self._p95_window("ttft", mdefs.SERVE_REQ_TTFT)
                    if self.ttft_p95_s > 0 else None)
        lat_p95 = (self._p95_window("latency", mdefs.SERVE_LATENCY)
                   if self.latency_p95_s > 0 else None)
        if not self._primed:
            self._primed = True
            return None
        if self.shed_rate > 0 and d_shed > 0 and d_total > 0:
            rate = d_shed / d_total
            if rate >= self.shed_rate:
                return {"signal": "shed_rate", "value": round(rate, 4),
                        "threshold": self.shed_rate}
        if ttft_p95 is not None and ttft_p95 > self.ttft_p95_s:
            return {"signal": "ttft_p95", "value": ttft_p95,
                    "threshold": self.ttft_p95_s}
        if lat_p95 is not None and lat_p95 > self.latency_p95_s:
            return {"signal": "latency_p95", "value": lat_p95,
                    "threshold": self.latency_p95_s}
        return None


# ---------------------------------------------------------------- arbiter
def _envf(name: str, default: str) -> float:
    return float(os.environ.get(name, default))


class ChipPoolArbiter:
    """The reconciler that owns the lease ledger and drives handoffs stage
    by stage. All durable state lives in the journal: the arbiter can die
    between any two ticks and a fresh instance resumes every lease
    mid-flight."""

    def __init__(self, serve: ServeWorkload, train: TrainWorkload,
                 kv=None, slo: Optional[SloGuard] = None,
                 policy: str = "diurnal",
                 tick_interval_s: float = 2.0):
        self.serve = serve
        self.train = train
        self.workloads = {"serve": serve, "train": train}
        self.ledger = PoolLedger(kv)
        self.slo = slo if slo is not None else SloGuard(serve.deployment)
        self.policy = policy
        self.tick_interval_s = tick_interval_s
        self.lease_s = _envf("RAY_TPU_POOL_LEASE_S", "900")
        self.stage_timeout_s = _envf("RAY_TPU_POOL_STAGE_TIMEOUT_S", "120")
        self.idle_ticks = int(_envf("RAY_TPU_POOL_IDLE_TICKS", "5"))
        self.step_chips = _units(_envf("RAY_TPU_POOL_STEP_CHIPS", "1"))
        self.idle_per_chip = _envf("RAY_TPU_POOL_IDLE_PER_CHIP", "0.1")
        self._idle_streak = 0
        self._tick_no = 0
        # Side effects this instance already issued per (lease, stage,
        # field): a restarted arbiter has an empty set, so it re-issues
        # each parked stage's recorded target exactly once.
        self._issued: set = set()
        # Last re-nudge time per stuck (lease, stage, field).
        self._nudged: Dict[Tuple, float] = {}
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.ledger.bootstrap(
            serve.target_chips(), train.chips(),
            meta={"serve_deployment": serve.deployment,
                  "train_run": train.run})

    # ------------------------------------------------------ public API
    def request_handoff(self, donor: str, chips: float,
                        lease_s: Optional[float] = None) -> str:
        """Journal an explicit handoff intent (the operator's and the
        diurnal policy's surface). Returns the lease id; the next ticks
        drive it."""
        lease = self.ledger.create_lease(
            donor, "train" if donor == "serve" else "serve",
            chips, lease_s if lease_s is not None else self.lease_s)
        logger.info("pool: lease %s %s->%s chips=%s",
                    lease["lease_id"], lease["donor"],
                    lease["recipient"], lease["chips"])
        return lease["lease_id"]

    def status(self) -> Dict[str, Any]:
        return {
            "tick": self._tick_no,
            "allocation": self.ledger.allocation(),
            "leases": self.ledger.leases(),
            "last_reversal": self.ledger.last_reversal(),
            "violations": self.ledger.verify(),
        }

    # ------------------------------------------------------------ tick
    def tick(self) -> Dict[str, Any]:
        from ray_tpu_torch._private import chaos
        from ray_tpu_torch._private import metrics_defs as mdefs

        self._tick_no += 1
        if chaos.enabled():
            # kill_arbiter fires here: the arbiter dies between journal
            # writes; a fresh instance must resume.
            chaos.inject("pool_tick", tick=self._tick_no)
        breach = self.slo.check() if self.slo is not None else None
        for lease in self.ledger.leases():
            if lease["stage"] in TERMINAL:
                continue
            try:
                self._advance(lease, breach)
            except Exception:  # noqa: BLE001 — one wedged lease must
                logger.exception(  # not stall the others
                    "pool: lease %s advance failed", lease["lease_id"])
        # One journal snapshot after the advances, shared by the policy,
        # the invariant check, the gauges and the returned status.
        leases = self.ledger.leases()
        if self.policy == "diurnal":
            try:
                self._policy(breach, leases)
            except Exception:  # noqa: BLE001 — the next tick retries
                logger.exception("pool: policy evaluation failed")
        violations = self.ledger.verify(leases)
        for v in violations:
            kind = v.split(":", 1)[0]
            mdefs.POOL_INVARIANT_VIOLATIONS.inc(tags={"kind": kind})
            logger.error("pool: INVARIANT VIOLATION %s", v)
        self._update_gauges(leases)
        return {"tick": self._tick_no, "breach": breach,
                "violations": violations,
                "allocation": self.ledger.allocation(leases)}

    # ----------------------------------------------------- lease drive
    def _chaos_handoff(self, lease: Dict[str, Any]) -> None:
        from ray_tpu_torch._private import chaos

        if chaos.enabled():
            d = chaos.inject("pool_handoff", stage=lease["stage"],
                             lease=lease["lease_id"],
                             direction=f"{lease['donor']}_to_"
                                       f"{lease['recipient']}")
            if d and d.get("preempted_node"):
                # The preemption notice is the cause: the same notice
                # drives the serve drains, so all reactions tie back to
                # one chain.
                _events.emit(
                    "pool.handoff_preempted",
                    cause=d.get("notice_id") or d.get("event_id", ""),
                    subject={"lease_id": lease["lease_id"],
                             "node": d["preempted_node"]},
                    stage=lease["stage"])
                logger.warning("pool: node %s preempted mid-handoff "
                               "(lease %s, stage %s)",
                               d["preempted_node"], lease["lease_id"],
                               lease["stage"])

    def _issue(self, lease: Dict[str, Any], workload, target_field: str,
               cause: str, capped: bool = True) -> None:
        """Issue a stage's recorded absolute target once per (lease,
        stage) per arbiter instance, so a restarted arbiter repeats the
        side effect exactly once from the journal. Marked issued only
        after the ask lands: a failed ask retries next tick."""
        key = (lease["lease_id"], lease["stage"], target_field)
        if key in self._issued:
            return
        workload.set_chips(lease[target_field], cause=cause,
                           capped=capped)
        self._issued.add(key)

    def _renudge(self, lease: Dict[str, Any], target_field: str) -> None:
        """A post-commit or rollback stage stopped converging past the
        stage timeout. These stages have no safe rollback (faking
        RETURNED/ABORTED would double-own cards), so re-publish the
        recorded target (the ask may have been lost) and log, at most
        once per timeout interval."""
        if not self._stage_timed_out(lease):
            return
        key = (lease["lease_id"], lease["stage"], target_field)
        now = time.monotonic()
        if now - self._nudged.get(key, 0.0) < self.stage_timeout_s:
            return
        self._nudged[key] = now
        self._issued.discard(key)
        logger.error(
            "pool: lease %s stuck in %s for %.0fs — re-issuing %s",
            lease["lease_id"], lease["stage"],
            self._stage_age(lease), target_field)

    def _stage_age(self, lease: Dict[str, Any]) -> float:
        return time.time() - lease["history"][-1][1]

    def _stage_timed_out(self, lease: Dict[str, Any]) -> bool:
        return self.stage_timeout_s > 0 and \
            self._stage_age(lease) > self.stage_timeout_s

    def _aborted(self, lease: Dict[str, Any], detail: str,
                 cause_event: str = "") -> None:
        from ray_tpu_torch._private import metrics_defs as mdefs

        self.ledger.advance(lease, ABORTED, detail, cause_event=cause_event)
        mdefs.POOL_HANDOFFS.inc(tags={
            "direction": f"{lease['donor']}_to_{lease['recipient']}",
            "outcome": "aborted"})

    def _advance(self, lease: Dict[str, Any],
                 breach: Optional[Dict[str, Any]]) -> None:
        from ray_tpu_torch._private import metrics_defs as mdefs

        donor = self.workloads[lease["donor"]]
        recipient = self.workloads[lease["recipient"]]
        stage = lease["stage"]
        direction = f"{lease['donor']}_to_{lease['recipient']}"
        self._chaos_handoff(lease)

        if stage == PENDING:
            if breach is not None and lease["donor"] == "serve":
                # The SLO guard: refuse to take serve cards while the
                # serve plane is already regressing.
                mdefs.POOL_SLO_REVERSALS.inc(tags={
                    "action": "refused", "signal": breach["signal"]})
                rev_ev = self.ledger.record_reversal(
                    lease, "refused", breach["signal"],
                    detail=f"value={breach['value']}")
                self._aborted(lease, f"slo {breach['signal']}", rev_ev)
                return
            donor_target = _units(donor.target_chips() - lease["chips"])
            if donor_target < donor.min_chips - _EPS:
                self._aborted(lease, "donor below min_chips")
                return
            if recipient.target_chips() < recipient.min_chips - _EPS:
                # A recipient below its own floor (a trainer whose group
                # never formed: world 0) could absorb the cards but never
                # give them back. Refuse now.
                self._aborted(lease, "recipient below min_chips — "
                                     "lease could not be returned")
                return
            lease = self.ledger.advance(
                lease, FREEING, f"donor -> {donor_target} chips",
                donor_target=donor_target)
            self._issue(lease, donor, "donor_target", "pool-free")
            return

        if stage == FREEING:
            self._issue(lease, donor, "donor_target", "pool-free")
            if donor.settled(lease["donor_target"]):
                self.ledger.advance(lease, FREED, "donor confirmed")
            elif self._stage_timed_out(lease):
                self._abort(lease, "FREEING timed out")
            return

        if stage == FREED:
            recip_target = _units(recipient.target_chips() + lease["chips"])
            lease = self.ledger.advance(
                lease, GRANTING, f"recipient -> {recip_target} chips",
                recipient_target=recip_target)
            self._issue(lease, recipient, "recipient_target",
                        "pool-grant")
            return

        if stage == GRANTING:
            self._issue(lease, recipient, "recipient_target",
                        "pool-grant")
            if recipient.settled(lease["recipient_target"]):
                now = time.time()
                lease = self.ledger.advance(
                    lease, COMMITTED, "recipient confirmed",
                    deadline_ts=now + lease["lease_s"])
                mdefs.POOL_HANDOFFS.inc(tags={"direction": direction,
                                              "outcome": "committed"})
                mdefs.POOL_HANDOFF_SECONDS.observe(
                    now - lease["created_ts"],
                    tags={"direction": direction})
            elif self._stage_timed_out(lease):
                self._abort(lease, "GRANTING timed out")
            return

        if stage == COMMITTED:
            if breach is not None and lease["donor"] == "serve":
                # Morning load: reverse the committed handoff.
                mdefs.POOL_SLO_REVERSALS.inc(tags={
                    "action": "reversed", "signal": breach["signal"]})
                rev_ev = self.ledger.record_reversal(
                    lease, "reversed", breach["signal"],
                    detail=f"value={breach['value']}")
                self._begin_return(lease, f"slo {breach['signal']}",
                                   cause_event=rev_ev)
            elif lease["deadline_ts"] is not None and \
                    time.time() > lease["deadline_ts"]:
                self._begin_return(lease, "lease deadline lapsed")
            return

        if stage == RETURN_FREEING:
            self._renudge(lease, "return_recipient_target")
            self._issue(lease, recipient, "return_recipient_target",
                        "pool-return-free")
            if recipient.settled(lease["return_recipient_target"]):
                donor_restore = _units(donor.target_chips()
                                       + lease["chips"])
                lease = self.ledger.advance(
                    lease, RETURN_GRANTING,
                    f"donor restore -> {donor_restore} chips",
                    return_donor_target=donor_restore)
                self._issue(lease, donor, "return_donor_target",
                            "pool-return-grant")
            return

        if stage == RETURN_GRANTING:
            self._renudge(lease, "return_donor_target")
            self._issue(lease, donor, "return_donor_target",
                        "pool-return-grant")
            if donor.settled(lease["return_donor_target"]):
                self.ledger.advance(lease, RETURNED, "chips returned")
                mdefs.POOL_HANDOFFS.inc(tags={"direction": direction,
                                              "outcome": "returned"})
                self._maybe_uncap(lease)
            return

        if stage == ABORTING:
            self._renudge(lease, "abort_donor_target")
            if lease.get("abort_recipient_target") is not None:
                # Undo the grant ask (journaled, so a crash between the
                # ABORTING write and this ask re-issues it on restart).
                # Not gated on: the recipient failing to settle is
                # usually why the lease is aborting.
                try:
                    self._issue(lease, recipient,
                                "abort_recipient_target", "pool-abort")
                except Exception:  # noqa: BLE001 — donor restore wins
                    logger.exception("pool: abort un-grant failed")
            self._issue(lease, donor, "abort_donor_target",
                        "pool-abort")
            if donor.settled(lease["abort_donor_target"]):
                self._aborted(lease, "rolled back")
                self._maybe_uncap(lease)
            return

    def _begin_return(self, lease: Dict[str, Any], detail: str,
                      cause_event: str = "") -> None:
        recipient = self.workloads[lease["recipient"]]
        give_back = _units(recipient.target_chips() - lease["chips"])
        lease = self.ledger.advance(
            lease, RETURN_FREEING, detail, cause_event=cause_event,
            return_recipient_target=give_back)
        self._issue(lease, recipient, "return_recipient_target",
                    "pool-return-free")

    def _abort(self, lease: Dict[str, Any], detail: str) -> None:
        """Roll a pre-commit lease back: journal both restore targets in
        the ABORTING record first (a crash right after still re-issues
        them on restart), then fire the ABORTING side effects."""
        donor = self.workloads[lease["donor"]]
        restore = _units(lease.get("donor_target", donor.target_chips())
                         + lease["chips"])
        fields: Dict[str, Any] = {"abort_donor_target": restore}
        if lease.get("recipient_target") is not None:
            fields["abort_recipient_target"] = _units(
                lease["recipient_target"] - lease["chips"])
        lease = self.ledger.advance(lease, ABORTING, detail, **fields)
        self._advance(lease, None)

    def _maybe_uncap(self, lease: Dict[str, Any]) -> None:
        """After a lease fully unwinds, lift the serve cap when no other
        live lease still holds serve cards."""
        live = [rec for rec in self.ledger.leases()
                if rec["stage"] not in TERMINAL
                and rec["lease_id"] != lease["lease_id"]
                and "serve" in (rec["donor"], rec["recipient"])]
        if not live:
            try:
                self.serve.clear_cap()
            except Exception:  # noqa: BLE001 — the next unwind lifts it
                logger.exception("pool: clear_cap failed")

    # ---------------------------------------------------------- policy
    def _policy(self, breach: Optional[Dict[str, Any]],
                leases: Optional[List[Dict[str, Any]]] = None) -> None:
        """The diurnal loop: serve idle for ``idle_ticks`` ticks in a row
        -> lease ``step_chips`` to training (never below the serve floor);
        an SLO breach reverses the newest committed serve->train lease
        (the COMMITTED handler journals it) and blocks new takes."""
        if breach is not None:
            self._idle_streak = 0
            return
        if leases is None:
            leases = self.ledger.leases()
        in_flight = [rec for rec in leases
                     if rec["stage"] in TRANSITIONAL
                     or rec["stage"] == PENDING]
        if in_flight:
            return  # one handoff at a time keeps confirmation crisp
        p = self.serve.pressure()
        chips = max(self.serve.target_chips(), 1)
        idle = (p["ongoing"] + p["queue"]) <= self.idle_per_chip * chips
        self._idle_streak = self._idle_streak + 1 if idle else 0
        if self._idle_streak < self.idle_ticks:
            return
        surplus = self.serve.target_chips() - self.serve.min_chips
        take = _units(min(self.step_chips, surplus))
        if take > 0:
            self.request_handoff("serve", take)
            self._idle_streak = 0

    # --------------------------------------------------------- metrics
    def _update_gauges(self, leases: Optional[List[Dict[str, Any]]] = None
                       ) -> None:
        from ray_tpu_torch._private import metrics_defs as mdefs

        if leases is None:
            leases = self.ledger.leases()
        alloc = self.ledger.allocation(leases)
        for owner in ("serve", "train", "in_flight"):
            mdefs.POOL_CHIPS.set(float(alloc[owner]),
                                 tags={"owner": owner})
        counts: Dict[str, int] = {}
        for lease in leases:
            if lease["stage"] not in TERMINAL:
                counts[lease["stage"]] = counts.get(lease["stage"], 0) + 1
        for stage in _LEASE_TRANSITIONS:
            if stage in TERMINAL:
                continue
            mdefs.POOL_LEASES.set(float(counts.get(stage, 0)),
                                  tags={"stage": stage})

    # ------------------------------------------------------- lifecycle
    def start(self) -> None:
        """Tick every ``tick_interval_s`` on a thread of its own until
        :meth:`stop`."""
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="chip-pool-arbiter")
        self._thread.start()

    def _loop(self) -> None:
        while not self._stop.wait(self.tick_interval_s):
            try:
                self.tick()
            except Exception:  # noqa: BLE001 — keep ticking
                logger.exception("pool: tick failed")

    def stop(self, timeout_s: float = 10.0) -> None:
        """Stop ticking and join the tick thread."""
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout_s)
            self._thread = None


# ------------------------------------------------------ offline readers
def read_pool_state(gcs_address: Optional[str] = None) -> Dict[str, Any]:
    """The pool's snapshot: config, allocation, leases (non-terminal
    first), in-flight handoffs and the last SLO-guard reversal, read from
    the GCS KV at ``gcs_address`` (no runtime needed), else from this
    process's ``internal_kv``."""
    store = GrpcKv(gcs_address) if gcs_address else InternalKv()

    def _load(key):
        raw = store.get(key)
        if raw is None:
            return None
        try:
            return json.loads(raw)
        except ValueError:
            return None

    config = _load("config")
    leases = [rec for rec in (_load(k) for k in sorted(store.keys("lease/")))
              if rec is not None]
    leases.sort(key=lambda r: (r["stage"] in TERMINAL, -r["created_ts"]))
    out: Dict[str, Any] = {
        "config": config,
        "leases": leases,
        "in_flight": [r for r in leases
                      if r["stage"] in TRANSITIONAL
                      or r["stage"] == PENDING],
        "last_reversal": _load("last_reversal"),
    }
    out["allocation"] = (compute_allocation(config, leases)
                         if config else None)
    return out


__all__ = [
    "ChipPoolArbiter", "DictKv", "GrpcKv", "InternalKv",
    "InvalidLeaseTransition", "PoolLedger", "ServeWorkload", "SloGuard",
    "TrainWorkload", "compute_allocation", "read_pool_state",
    "PENDING", "FREEING", "FREED", "GRANTING", "COMMITTED",
    "RETURN_FREEING", "RETURN_GRANTING", "RETURNED", "ABORTING",
    "ABORTED", "TERMINAL", "TRANSITIONAL", "POOL_KV_NS",
]

"""Deterministic chaos injection for fault-tolerance tests (the port of
``ray_tpu/_private/chaos.py``).

Framework code calls :func:`inject` at named injection **sites**, and an
installed :class:`ChaosPlan` decides, deterministically, whether a fault
fires there. The port puts sites on the serve plane: the replica
lifecycle (``serve_replica``: ``phase=prefill|decode|drain``), the drain
wait (``serve_drain``), the router's pressure fetch (``serve_pressure``),
the engine's tick (``serve_tick``) and both sides of the KV handoff
(``kv_transfer``: ``stage=export|import``). The train, checkpoint, pool
and learner sites of the JAX package come with ROADMAP items 8b, 10 and
12; their actions are parsed here already (the action-to-site table is
JAX's, entry for entry).

Determinism contract: a plan is a seed plus an ordered rule list. Rules
matched by exact coordinates (``stage=export``) fire wherever the
coordinates match; probabilistic rules (``p=0.25``) flip a coin that is
a pure function of ``(seed, rule id, site, coordinates)``, so the same
seed replays the same fault sequence. Every firing is appended to the
injection log (:func:`injection_log`) that tests assert on, and is a
``chaos.inject`` flight event (:mod:`ray_tpu_torch._private.events`)
whose id rides the log entry, the returned directives and a kill's
:class:`SimulatedProcessDeath`, so the recovery it causes can cite it as
its ``cause``. ``times`` caps firings (default 1; ``-1`` is unlimited).

Activation: programmatic (``chaos.configure("kill_transfer:stage=export",
seed=7)``) or by environment: ``RAY_TPU_CHAOS`` holds the spec and
``RAY_TPU_CHAOS_SEED`` the seed, read at a process's first
:func:`inject`. With no plan installed, :func:`inject` is one attribute
check.

Across processes. The port's serve replicas are spawned processes (the
JAX package hosts them in-process), so one plan spans the serving
process and its replicas:

* the serving process's controller pushes the plan and the firings
  spent so far (:func:`state`) to every running replica whenever either
  changes (:func:`subscribe`), and to every replica it spawns, which
  :func:`install` s it; a respawned replica so never refires a spent
  ``times=1`` rule;
* a replica asks the serving process before it acts on a capped rule
  (:func:`set_arbiter`; the serving process decides in
  :func:`arbitrate`, counts the firing, emits its ``chaos.inject``
  event there and logs it under that event's id), so ``times`` holds
  across replicas and the firing is in the serving process's log and
  flight ring before a kill can stop the replica. Unlimited rules are
  reported, not asked: the replica emits their event (its flight sink
  carries it to the serving process) and reports it under that id.
  A kill in a replica is ``os._exit`` (``RAY_TPU_CHAOS_HARD_EXIT=1``,
  which replica processes set).

Spec grammar (semicolon-separated rules)::

    RAY_TPU_CHAOS="kill_transfer:stage=import;delay_tick:secs=0.05,times=-1"

Matching keys (all optional): ``rank``, ``step``, ``proc``, ``node``,
``run``, ``phase``, ``token``, ``stage``, ``tick``.
"""

from __future__ import annotations

import logging
import os
import random
import threading
import time
import zlib
from typing import Any, Callable, Dict, List, Optional, Tuple

from ray_tpu_torch._private import events as _events

logger = logging.getLogger(__name__)

__all__ = [
    "ChaosPlan", "ChaosRule", "SimulatedProcessDeath", "arbitrate",
    "configure", "current_plan", "enabled", "inject", "injection_log",
    "install", "process_dying", "reset", "set_arbiter", "state",
    "subscribe", "unsubscribe",
]


class SimulatedProcessDeath(BaseException):
    """Raised by the kill actions where the process must not really exit
    (a deployment held in the serving process). A ``BaseException``, so
    code catching ``Exception`` does not swallow it. Replica processes
    exit instead (``RAY_TPU_CHAOS_HARD_EXIT=1``)."""

    def __init__(self, reason: str = "chaos: worker killed",
                 event_id: str = ""):
        self.reason = reason
        # Id of the firing that killed this process (its log entry's).
        self.event_id = event_id
        super().__init__(reason)


# Site each action fires at.
_ACTION_SITES = {
    "kill_worker": "train_step",
    "slow_step": "train_step",
    "resize": "train_step",
    "drop_heartbeat": "train_heartbeat",
    "delay_heartbeat": "train_heartbeat",
    "drop_node_hb": "node_heartbeat",
    "drop_agent_vitals": "agent_vitals",
    "fail_shard_write": "ckpt_shard_write",
    "corrupt_shard": "ckpt_shard_file",
    # Serve-plane sites: replica lifecycle faults.
    "kill_replica": "serve_replica",
    "drop_pressure": "serve_pressure",
    "delay_tick": "serve_tick",
    "delay_drain": "serve_drain",
    # The prefill/decode split: deaths and delays mid-KV-transfer
    # (matchable on stage=export|import, the side of the handoff).
    "kill_transfer": "kv_transfer",
    "delay_transfer": "kv_transfer",
    # Chip-pool / autoscaler sites.
    "preempt_node": "pool_handoff",
    "kill_arbiter": "pool_tick",
    "fail_create_node": "provider_create",
    # RL / learner-plane sites.
    "perturb_learner": "learner_weights",
}
_MATCH_KEYS = ("rank", "step", "proc", "node", "run", "phase", "token",
               "stage", "tick")
_INT_PARAMS = ("rank", "step", "proc", "times", "resize", "world", "token",
               "tick")
_FLOAT_PARAMS = ("secs", "p", "jitter", "eps")
_KILLS = ("kill_worker", "kill_replica", "kill_arbiter", "kill_transfer")
_PREEMPT_ITEM = "item 8b (the trainer controller and its preemption plane)"


class ChaosRule:
    def __init__(self, action: str, params: Dict[str, Any], rule_id: str):
        if action not in _ACTION_SITES:
            raise ValueError(
                f"unknown chaos action {action!r} "
                f"(known: {sorted(_ACTION_SITES)})")
        self.action = action
        self.site = _ACTION_SITES[action]
        self.id = rule_id
        self.params = params
        self.match = {k: params[k] for k in _MATCH_KEYS if k in params}
        self.times = int(params.get("times", 1))
        self.p = params.get("p")

    def matches(self, site: str, coords: Dict[str, Any]) -> bool:
        if site != self.site:
            return False
        for key, want in self.match.items():
            if key not in coords or coords[key] != want:
                return False
        return True

    def __repr__(self):
        kv = ",".join(f"{k}={v}" for k, v in sorted(self.params.items()))
        return f"ChaosRule({self.action}:{kv})"


class ChaosPlan:
    """A parsed spec: ordered rules + the seed that makes them replayable."""

    def __init__(self, rules: List[ChaosRule], seed: int = 0):
        self.rules = rules
        self.seed = int(seed)

    @classmethod
    def parse(cls, spec: str, seed: int = 0) -> "ChaosPlan":
        rules = []
        for i, part in enumerate(p for p in spec.split(";") if p.strip()):
            action, _, rest = part.strip().partition(":")
            params: Dict[str, Any] = {}
            for kv in (x for x in rest.split(",") if x.strip()):
                key, _, val = kv.partition("=")
                key = key.strip()
                val = val.strip()
                if key in _INT_PARAMS:
                    params[key] = int(val)
                elif key in _FLOAT_PARAMS:
                    params[key] = float(val)
                else:
                    params[key] = val
            rules.append(ChaosRule(action.strip(), params,
                                   rule_id=f"{action.strip()}#{i}"))
        return cls(rules, seed=seed)


# ----------------------------------------------------------- module state
_lock = threading.Lock()
_plan: Optional[ChaosPlan] = None
_env_checked = False
_fired: Dict[str, int] = {}
_log: List[Dict[str, Any]] = []
_MAX_LOG = 1000
_tls = threading.local()
# Bumped by every configure/reset: a replica's firing asked under an
# older plan is refused.
_generation = 0
# The serving process: called (no arguments) after the plan or a capped
# rule's firings change, to push :func:`state` to the replicas.
_listeners: List[Callable[[], None]] = []
# A replica process: ``fn(generation, rule, entry) -> bool`` asks the
# serving process whether a firing may act.
_arbiter: Optional[Callable[[int, ChaosRule, Dict[str, Any]], bool]] = None


def _notify() -> None:
    for cb in list(_listeners):
        try:
            cb()
        except Exception:  # noqa: BLE001 — one bad listener only
            logger.exception("chaos listener failed")


def configure(spec: Optional[str] = None, seed: int = 0,
              plan: Optional[ChaosPlan] = None) -> Optional[ChaosPlan]:
    """Install a chaos plan programmatically (tests). ``spec=None`` and
    ``plan=None`` clears it. Clears the firing state and injection log."""
    global _plan, _env_checked, _generation
    with _lock:
        _plan = plan if plan is not None else (
            ChaosPlan.parse(spec, seed=seed) if spec else None)
        _env_checked = True  # programmatic config wins over env
        _generation += 1
        _fired.clear()
        del _log[:]
        out = _plan
    _notify()
    return out


def reset() -> None:
    """Drop any installed plan and firing state; env is re-read lazily."""
    global _plan, _env_checked, _generation
    with _lock:
        _plan = None
        _env_checked = False
        _generation += 1
        _fired.clear()
        del _log[:]
    _tls.dying = False
    _notify()


def current_plan() -> Optional[ChaosPlan]:
    global _plan, _env_checked
    if not _env_checked:
        with _lock:
            if not _env_checked:
                spec = os.environ.get("RAY_TPU_CHAOS", "")
                if spec:
                    try:
                        _plan = ChaosPlan.parse(
                            spec,
                            seed=int(os.environ.get(
                                "RAY_TPU_CHAOS_SEED", "0")))
                    except Exception:  # noqa: BLE001 — bad spec: no chaos
                        logger.exception("invalid RAY_TPU_CHAOS spec %r",
                                         spec)
                        _plan = None
                _env_checked = True
    return _plan


def enabled() -> bool:
    return current_plan() is not None


def injection_log() -> List[Dict[str, Any]]:
    with _lock:
        return list(_log)


def process_dying() -> bool:
    """True on the thread currently unwinding a simulated process kill."""
    return bool(getattr(_tls, "dying", False))


def _clear_dying() -> None:
    _tls.dying = False


# ------------------------------------------------------ across processes
def state() -> Tuple[int, Optional[ChaosPlan], Dict[str, int]]:
    """``(generation, plan, firings by rule id)``: what a replica process
    :func:`install` s to share this process's plan."""
    plan = current_plan()
    with _lock:
        return _generation, plan, dict(_fired)


def install(shared: Tuple[int, Optional[ChaosPlan], Dict[str, int]]) -> None:
    """Adopt the serving process's :func:`state` (in a replica process).
    Firings of the same plan only grow: a push that crossed a firing
    this process was granted keeps the larger count."""
    global _plan, _env_checked, _generation
    generation, plan, fired = shared
    with _lock:
        if generation != _generation:
            _fired.clear()
        for rule_id, n in fired.items():
            _fired[rule_id] = max(_fired.get(rule_id, 0), n)
        _plan = plan
        _env_checked = True
        _generation = generation


def subscribe(callback: Callable[[], None]) -> None:
    """``callback()`` runs after every change of the plan and every
    firing of a capped rule (the serving process pushes :func:`state`)."""
    with _lock:
        _listeners.append(callback)


def unsubscribe(callback: Callable[[], None]) -> None:
    with _lock:
        if callback in _listeners:
            _listeners.remove(callback)


def set_arbiter(fn: Optional[Callable[[int, ChaosRule, Dict[str, Any]],
                                      bool]]) -> None:
    """Route this process's firings through ``fn`` (a replica process
    asks the serving process; None decides locally)."""
    global _arbiter
    _arbiter = fn


def arbitrate(generation: int, rule_id: str,
              entry: Dict[str, Any]) -> str:
    """Decide a replica's firing in the serving process: its event id
    when the plan it was asked under is still installed and the rule has
    firings left, else "". A granted firing is counted and logged here,
    under the ``chaos.inject`` event this process emits for it (or, for
    a reported unlimited firing, the event the replica emitted)."""
    with _lock:
        plan = _plan
        rule = None if plan is None or generation != _generation else next(
            (r for r in plan.rules if r.id == rule_id), None)
        if rule is None or (rule.times >= 0
                            and _fired.get(rule_id, 0) >= rule.times):
            return ""
        _fired[rule_id] = _fired.get(rule_id, 0) + 1
        logged = {**entry, "seq": len(_log)}
        if len(_log) < _MAX_LOG:
            _log.append(logged)
    logged["event_id"] = entry.get("event_id") or _emit_injection(
        entry.get("action", rule.action), entry.get("site", rule.site),
        rule_id, entry.get("coords") or {})
    if rule.times >= 0:
        _notify()
    return logged["event_id"]


# ------------------------------------------------------------- injection
def _unit(plan: ChaosPlan, rule: ChaosRule,
          site: str, coords: Dict[str, Any]) -> float:
    """Deterministic unit draw in [0, 1): pure function of (seed, rule,
    site, coords) so a replay with the same seed sees the same values."""
    key = f"{plan.seed}:{rule.id}:{site}:" + ",".join(
        f"{k}={coords[k]}" for k in sorted(coords)
        if isinstance(coords[k], (int, str)))
    h = zlib.crc32(key.encode())
    return random.Random(h).random()


def _coin(plan: ChaosPlan, rule: ChaosRule,
          site: str, coords: Dict[str, Any]) -> bool:
    """Deterministic Bernoulli draw (see :func:`_unit`)."""
    return _unit(plan, rule, site, coords) < float(rule.p)


def inject(site: str, **coords: Any) -> Optional[Dict[str, Any]]:
    """Consult the plan at an injection site.

    Returns a directive dict for cooperative actions (``{"drop": True}``,
    ``{"delay_s": x}``), ``None`` when nothing fires. Disruptive actions
    act directly: the delays sleep here, ``fail_shard_write`` raises
    ``OSError``, ``corrupt_shard`` flips a byte of ``coords["path"]``,
    the kills raise :class:`SimulatedProcessDeath` (or exit the process
    under ``RAY_TPU_CHAOS_HARD_EXIT=1``)."""
    plan = current_plan()
    if plan is None:
        return None
    directives: Dict[str, Any] = {}
    for rule in plan.rules:
        if not rule.matches(site, coords):
            continue
        arbiter = _arbiter
        with _lock:
            if rule.times >= 0 and _fired.get(rule.id, 0) >= rule.times:
                continue
            if rule.p is not None and not _coin(plan, rule, site, coords):
                continue
            entry = {
                "seq": len(_log), "action": rule.action, "site": site,
                "rule": rule.id, "ts": time.time(),
                "coords": {k: v for k, v in coords.items()
                           if isinstance(v, (int, float, str))},
                "pid": os.getpid()}
            generation = _generation
            if arbiter is None:
                _fired[rule.id] = _fired.get(rule.id, 0) + 1
                if len(_log) < _MAX_LOG:
                    _log.append(entry)
        if arbiter is None:
            entry["event_id"] = _emit_injection(rule.action, site, rule.id,
                                                coords)
        else:
            # Asked (a capped rule: the serving process emits the event)
            # or reported (an unlimited one: emitted here first) before
            # anything acts: a kill below ends this process.
            if rule.times < 0:
                entry["event_id"] = _emit_injection(rule.action, site,
                                                    rule.id, coords)
            granted = arbiter(generation, rule, entry)
            if not granted:
                continue
            if not entry.get("event_id"):
                entry["event_id"] = (
                    granted if isinstance(granted, str)
                    else _emit_injection(rule.action, site, rule.id, coords))
            with _lock:
                _fired[rule.id] = _fired.get(rule.id, 0) + 1
                if len(_log) < _MAX_LOG:
                    _log.append({**entry, "seq": len(_log)})
        _apply(plan, rule, site, coords, directives, entry["event_id"])
        directives["event_id"] = entry["event_id"]
    return directives or None


def _emit_injection(action: str, site: str, rule_id: str,
                    coords: Dict[str, Any]) -> str:
    """The firing's ``chaos.inject`` flight event (a chain root); its
    subject is the coordinates that name what was hit."""
    subject: Dict[str, Any] = {}
    for ck, sk in (("lease", "lease_id"), ("replica", "replica"),
                   ("node", "node"), ("run", "run"),
                   ("deployment", "deployment")):
        v = coords.get(ck)
        if isinstance(v, (int, str)):
            subject[sk] = v
    return _events.emit("chaos.inject", subject=subject,
                        action=action, site=site, rule=rule_id)


def _apply(plan: ChaosPlan, rule: ChaosRule, site: str,
           coords: Dict[str, Any], directives: Dict[str, Any],
           event_id: str = "") -> None:
    action = rule.action
    logger.warning("chaos: injecting %s at %s %s", action, site, coords)
    if action in _KILLS:
        resize = rule.params.get("resize")
        if resize:
            _publish_resize(int(resize), reason="chaos-node-lost")
        if os.environ.get("RAY_TPU_CHAOS_HARD_EXIT") == "1":
            os._exit(17)  # a real replica process: die like a killed host
        _tls.dying = True
        raise SimulatedProcessDeath(
            f"chaos {action} at {site} {coords}", event_id=event_id)
    if action == "slow_step":
        delay = float(rule.params.get("secs", 1.0))
        jitter = rule.params.get("jitter")
        if jitter:
            # Seed-deterministic latency: scale by [1, 1+jitter) drawn
            # from (seed, rule, coords), salted apart from the p= coin.
            delay *= 1.0 + float(jitter) * _unit(plan, rule,
                                                 site + ":jitter",
                                                 coords)
        time.sleep(delay)
        directives["slept_s"] = delay
    elif action == "resize":
        _publish_resize(int(rule.params["world"]), reason="chaos-resize")
    elif action == "fail_shard_write":
        raise OSError(f"chaos fail_shard_write at {coords}")
    elif action == "corrupt_shard":
        path = coords.get("path")
        if path:
            _corrupt_file(str(path))
    elif action in ("drop_heartbeat", "drop_node_hb",
                    "drop_agent_vitals", "drop_pressure"):
        directives["drop"] = True
    elif action == "delay_heartbeat":
        directives["delay_s"] = float(rule.params.get("secs", 1.0))
    elif action in ("delay_tick", "delay_drain", "delay_transfer"):
        # A stuttering engine tick, drain wait or KV handoff, with every
        # request still alive.
        delay = float(rule.params.get("secs", 0.05))
        time.sleep(delay)
        directives["slept_s"] = delay
    elif action == "preempt_node":
        from ray_tpu_torch.models.llama import not_ported

        raise not_ported("the preempt_node chaos action (preemption "
                         "notices)", _PREEMPT_ITEM)
    elif action == "fail_create_node":
        raise RuntimeError(f"chaos fail_create_node at {coords}")
    elif action == "perturb_learner":
        # Cooperative: the matched learner nudges its reported weights.
        directives["perturb"] = float(rule.params.get("eps", 1e-3))


def _publish_resize(world_target: int, reason: str) -> None:
    from ray_tpu_torch.models.llama import not_ported

    raise not_ported(f"resize hints ({reason}, world {world_target})",
                     _PREEMPT_ITEM)


def _corrupt_file(path: str) -> None:
    """Flip one byte in the middle of ``path``."""
    try:
        size = os.path.getsize(path)
        with open(path, "r+b") as f:
            f.seek(size // 2)
            b = f.read(1)
            f.seek(size // 2)
            f.write(bytes([b[0] ^ 0xFF]) if b else b"\xff")
        logger.warning("chaos: corrupted one byte of %s", path)
    except OSError:
        logger.exception("chaos: failed to corrupt %s", path)


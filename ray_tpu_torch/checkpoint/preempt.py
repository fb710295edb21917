"""Preemption plane (port of ``ray_tpu/checkpoint/preempt.py``):
SIGTERM / maintenance-event watch → PREEMPT notices.

Hosts lose cards routinely (spot preemption, maintenance events). The
node agent (or any process) watches for the death notice and publishes
a ``PREEMPT`` record; registered training processes run a just-in-time
checkpoint before the host dies, and the trainer controller treats the
loss as retryable and resumes from the newest committed manifest
(``ray_tpu_torch/checkpoint/plane.py``).

The JAX package publishes on its GCS pubsub channel. The port has no
GCS: a notice goes through the ``torch.distributed`` store (a
``TCPStore``) that the trainer controller hosts (:func:`attach` names it
for this process). :func:`publish_preempt` appends the notice under the
store's ``__train__/preempt/`` keys (a counter and one key a notice),
and every process that listens on that store (:func:`ensure_listener`:
the controller for resize asks, each worker for its
:class:`PreemptionGuard`) polls the counter and fires its callbacks for
each notice published since it subscribed. A process attached to no
store fires its own callbacks at once, so the whole flow stays testable
in one process.
"""

from __future__ import annotations

import logging
import os
import pickle
import signal
import threading
import time
from datetime import timedelta
from typing import Any, Callable, Dict, Optional

logger = logging.getLogger(__name__)

PREEMPT_CHANNEL = "PREEMPT"
# The channel's keys in the controller's store.
_PREFIX = "__train__/preempt/"
_SEQ_KEY = _PREFIX + "seq"
# Seconds between a listener's reads of the counter.
POLL_S = 0.05
# A store client's timeout (connect, and a read of a notice key).
STORE_TIMEOUT_S = 30.0

_state_lock = threading.Lock()
_callbacks: list = []
_listeners: Dict[str, threading.Event] = {}
# "host:port" of the store this process publishes to and listens on.
_address: Optional[str] = None


def connect_store(address: str, timeout_s: float = STORE_TIMEOUT_S):
    """A client of the ``TCPStore`` at ``host:port``."""
    import torch.distributed as dist

    host, _, port = address.rpartition(":")
    return dist.TCPStore(host, int(port), is_master=False,
                         timeout=timedelta(seconds=timeout_s))


def attach(address: Optional[str]) -> None:
    """Name the store (``host:port``) this process publishes notices to
    and listens on (None: none; notices then fire locally)."""
    global _address
    with _state_lock:
        _address = address


def attached() -> Optional[str]:
    with _state_lock:
        return _address


def register_preempt_callback(fn: Callable[[Dict[str, Any]], None]):
    """Register ``fn(notice)`` to run when a preemption notice reaches
    this process (local publish or a notice read off the store). Returns
    ``fn`` as the unregister handle."""
    with _state_lock:
        _callbacks.append(fn)
    return fn


def unregister_preempt_callback(fn) -> None:
    with _state_lock:
        try:
            _callbacks.remove(fn)
        except ValueError:
            pass


def notify_preemption(notice: Dict[str, Any]) -> None:
    """Fire this process's registered callbacks (each isolated — a bad
    callback must not stop the JIT saves of the others)."""
    from ray_tpu_torch._private import metrics_defs as mdefs

    mdefs.CKPT_PREEMPT_NOTICES.inc(
        tags={"source": str(notice.get("source", "local"))})
    with _state_lock:
        callbacks = list(_callbacks)
    for fn in callbacks:
        try:
            fn(dict(notice))
        except Exception:  # noqa: BLE001
            logger.exception("preemption callback failed")


def _publish_to_store(address: str, notice: Dict[str, Any]) -> None:
    store = connect_store(address)
    seq = store.add(_SEQ_KEY, 1)
    store.set(f"{_PREFIX}{seq}", pickle.dumps(notice))


def publish_preempt(reason: str = "preempted", node: str = "*",
                    store_address: Optional[str] = None,
                    deadline_s: Optional[float] = None,
                    world_target: Optional[int] = None,
                    kind: Optional[str] = None,
                    cause: str = "") -> Dict[str, Any]:
    """Publish a preemption notice to every process listening on the
    store (``store_address``, else the one :func:`attach` named); with
    no store the notice fires locally instead. ``node`` scopes delivery
    (``*`` = every subscriber).

    The channel doubles as the elastic-resize signal plane:
    ``world_target=N`` asks running trainers to re-form their worker
    groups at N workers (``ray_tpu_torch.train.elastic.request_resize``),
    and ``kind="capacity"`` is the cluster-grew hint — both are latched by
    :class:`ray_tpu_torch.train.elastic.ResizeGuard` rather than the
    JIT-save guards."""
    notice = {"reason": reason, "node": node or "*", "ts": time.time(),
              "source": "publish"}
    if deadline_s is not None:
        notice["deadline_s"] = float(deadline_s)
    if world_target is not None:
        notice["world_target"] = int(world_target)
    if kind is not None:
        notice["kind"] = str(kind)
    # The notice id IS its flight-recorder event id: every plane that
    # reacts (trainer JIT-save/recovery) records it as their cause, tying
    # the whole fan-out to one chain. ``cause`` links the notice itself
    # to its trigger (e.g. a chaos injection).
    from ray_tpu_torch._private import events as _events

    notice["notice_id"] = _events.emit(
        "preempt.notice", cause=cause,
        subject={"node": notice["node"]}, reason=reason,
        world_target=world_target, kind=kind)
    address = store_address or attached()
    if address:
        _publish_to_store(address, notice)
    else:
        notify_preemption(notice)
    return notice


def start_preempt_listener(store_address: str,
                           node_id: Optional[str] = None) -> None:
    """Listen on the store for PREEMPT notices (idempotent per address):
    each notice published after this call fires this process's
    callbacks. Notices scoped to another node are ignored."""
    with _state_lock:
        if store_address in _listeners:
            return
        stop = _listeners[store_address] = threading.Event()
    store = connect_store(store_address)
    start = store.add(_SEQ_KEY, 0)
    threading.Thread(target=_listener_loop,
                     args=(store_address, store, start, node_id or "",
                           stop),
                     daemon=True, name="preempt-listener").start()


def ensure_listener(store_address: Optional[str] = None,
                    node_id: Optional[str] = None) -> None:
    """Listen for PREEMPT notices on ``store_address`` (else the store
    :func:`attach` named). No-op without one — local publishes still
    reach registered callbacks — and a failed subscribe is logged, never
    raised (shared bootstrap for :class:`PreemptionGuard` and
    ``train.elastic.ResizeGuard``)."""
    address = store_address or attached()
    if address:
        try:
            start_preempt_listener(address, node_id=node_id)
        except Exception:  # noqa: BLE001 — guard still works locally
            logger.exception("preempt listener failed to start")


def stop_listener(store_address: str) -> None:
    """Stop this process's listener on one store (its trainer ended)."""
    with _state_lock:
        stop = _listeners.pop(store_address, None)
    if stop is not None:
        stop.set()


def stop_listeners() -> None:
    with _state_lock:
        for stop in _listeners.values():
            stop.set()
        _listeners.clear()


def _listener_loop(address: str, store, seen: int, node_id: str,
                   stop: threading.Event) -> None:
    while not stop.wait(POLL_S):
        try:
            last = store.add(_SEQ_KEY, 0)
            while seen < last and not stop.is_set():
                seen += 1
                notice = pickle.loads(store.get(f"{_PREFIX}{seen}"))
                target = str(notice.get("node", "*"))
                if target in ("", "*", "all") or not node_id or \
                        node_id == target or node_id.startswith(target):
                    notify_preemption(dict(notice, source="pubsub"))
        except Exception:  # noqa: BLE001 — the store's host is gone
            logger.info("preempt listener on %s stopped: the store is "
                        "unreachable", address)
            break
    with _state_lock:
        if _listeners.get(address) is stop:
            del _listeners[address]


class PreemptionGuard:
    """Training-loop side: latches the first preemption notice so the
    step loop can run a just-in-time save at a safe point.

    In a trainer's worker the guard also listens on the controller's
    store (the one the worker is attached to)."""

    def __init__(self, store_address: Optional[str] = None,
                 node_id: Optional[str] = None):
        self._event = threading.Event()
        self._notice: Optional[Dict[str, Any]] = None

        def on_notice(notice: Dict[str, Any]) -> None:
            # Elastic control signals (world-target asks, capacity
            # hints) ride this channel but are ResizeGuard's to latch —
            # they must not trigger a JIT save + PreemptedError in every
            # running train loop.
            if notice.get("kind") == "capacity" or \
                    notice.get("world_target") is not None:
                return
            self._notice = notice
            self._event.set()

        self._cb = register_preempt_callback(on_notice)
        ensure_listener(store_address, node_id=node_id)

    @property
    def triggered(self) -> bool:
        return self._event.is_set()

    @property
    def notice(self) -> Optional[Dict[str, Any]]:
        return self._notice

    def wait(self, timeout: Optional[float] = None) -> bool:
        return self._event.wait(timeout)

    def close(self) -> None:
        unregister_preempt_callback(self._cb)

    def __enter__(self) -> "PreemptionGuard":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


class PreemptionWatcher:
    """Host side: turns SIGTERM and the maintenance-event sentinel into
    one PREEMPT publish (a node agent runs one per host).

    ``sentinel_path`` (default ``$RAY_TPU_MAINTENANCE_SENTINEL``) is
    polled for existence — cloud providers surface maintenance events as
    a droppable file/flag; tests touch the file. Signal installation is
    opt-in: handlers only install from the main thread of a process that
    owns its lifecycle, never from embedded library code."""

    def __init__(self, node_id: str = "",
                 store_address: Optional[str] = None,
                 sentinel_path: Optional[str] = None,
                 install_signal: bool = False, poll_s: float = 1.0):
        self.node_id = node_id
        self.store_address = store_address
        self.sentinel_path = (sentinel_path if sentinel_path is not None
                              else os.environ.get(
                                  "RAY_TPU_MAINTENANCE_SENTINEL", ""))
        self._fired = threading.Event()
        self._stop = threading.Event()
        self._prev_handler = None
        if install_signal:
            try:
                self._prev_handler = signal.signal(
                    signal.SIGTERM, self._on_sigterm)
            except ValueError:  # not the main thread
                logger.warning("PreemptionWatcher: cannot install "
                               "SIGTERM handler off the main thread")
        if self.sentinel_path:
            threading.Thread(target=self._poll_loop, args=(poll_s,),
                             daemon=True,
                             name="preempt-sentinel").start()

    def _on_sigterm(self, signum, frame) -> None:
        self.trigger("SIGTERM")
        prev = self._prev_handler
        if callable(prev):
            prev(signum, frame)

    def _poll_loop(self, poll_s: float) -> None:
        while not self._stop.wait(poll_s):
            try:
                if os.path.exists(self.sentinel_path):
                    self.trigger("maintenance-event")
                    return
            except OSError:
                pass

    def trigger(self, reason: str) -> None:
        """Publish the PREEMPT notice exactly once."""
        if self._fired.is_set():
            return
        self._fired.set()
        logger.warning("preemption detected on node %s: %s",
                       self.node_id[:12] or "?", reason)
        try:
            publish_preempt(reason=reason, node=self.node_id or "*",
                            store_address=self.store_address)
        except Exception:  # noqa: BLE001 — the host is dying; best effort
            logger.exception("failed to publish PREEMPT notice")

    @property
    def fired(self) -> bool:
        return self._fired.is_set()

    def stop(self) -> None:
        self._stop.set()

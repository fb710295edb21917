"""KV-block transfer between a prefill-role and a decode-role
``ContinuousBatcher`` (port of ``ray_tpu/serve/kv_transfer.py``).

Every movement of arena blocks between engines goes through this module:
a test pins the engine's ``export_kv_payload`` / ``import_kv_payload``
calls inside ``ray_tpu_torch`` to it, so no bare write of arena bytes
creeps in beside the journal.

* **export** (prefill engine): :func:`export_kv` gathers the parked
  request's prompt blocks (K/V and int8 scale sidecars) into one host
  staging buffer with a crc32 manifest, in the JAX package's wire format,
  so either package imports the other's payloads;
* **import** (decode engine): :func:`import_kv` crc-checks the bytes,
  scatters them into (reserved) blocks, indexes the prompt in the radix
  tree and starts decoding;
* :func:`transfer_inproc` does both for two engines in one process, the
  staging buffer passed by reference, and notes the handoff on a journal
  when given one;
* :func:`send_handoff` / :func:`receive_handoff` move a handoff between
  replica processes: the prefill side exports and writes the staging
  bytes (a host ``numpy.uint8`` buffer, JAX's wire format) into a fresh
  shm channel (:class:`~ray_tpu_torch.experimental.channel.Channel`) and
  returns the small manifest (the payload without the bytes, plus the
  channel's reader attach-spec), which crosses the ordinary replica
  pipe; the decode side reads the bytes, unlinks the segment and
  imports. A manifest the router never journaled is refused
  (``RequestJournal.note_handoff``): an unjournaled transfer could bill
  a request twice after a death on either side.

Chaos sites ``kv_transfer`` (``kill_transfer`` / ``delay_transfer``,
matchable on ``stage=export|import``) fire inside the owning replica
process before the gather and before the scatter, so an injected death
is a real process death the journal must recover from.

Each payload carries its ``breakdown`` (``export_s``, ``channel_s``
summed over the write and the read, then ``import_s``), which lands in
the decode engine's request record. Each leg is observed as in JAX
(``_observe``): ``SERVE_KV_TRANSFER_SECONDS``, ``_BYTES`` and
``_BLOCKS``, tagged with the deployment and the direction (export,
channel, import; the channel once on each side), and a payload that
fails its crc check counts ``SERVE_HANDOFFS`` ``crc_mismatch``.

Knobs: ``RAY_TPU_KV_TRANSFER_TIMEOUT_S`` (the channel read's wait,
default 30), ``RAY_TPU_KV_TRANSFER_TTL_S`` (the reap of a channel whose
reader never came, default 120).
"""

from __future__ import annotations

import os
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from ray_tpu_torch._private import chaos
from ray_tpu_torch._private import metrics_defs as mdefs

__all__ = ["export_kv", "import_kv", "send_handoff", "receive_handoff",
           "transfer_inproc", "reap_channels", "transfer_timeout_s"]

#: The payload key that rides the channel alone (everything else is the
#: manifest).
_BODY_KEY = "staging"


def transfer_timeout_s() -> float:
    """The channel read's wait for the staging bytes (read per transfer,
    so tests and operators retune it live)."""
    return float(os.environ.get("RAY_TPU_KV_TRANSFER_TIMEOUT_S", "30"))


def _channel_ttl_s() -> float:
    return float(os.environ.get("RAY_TPU_KV_TRANSFER_TTL_S", "120"))


# Writer-side channels awaiting their one reader. The decode side
# unlinks the segment after reading; entries here matter only when the
# decode side never comes (a death mid-handoff, a dropped manifest) and
# are reaped past the TTL, so orphaned segments cannot pile up.
_PENDING: List[Tuple[Any, float]] = []
_PENDING_LOCK = threading.Lock()


def reap_channels(force: bool = False) -> int:
    """Destroy writer-side channels whose reader never came (all of them
    with ``force=True``: a replica's stop). Returns the count reaped.
    Destroying a segment the reader already unlinked is a no-op."""
    now = time.monotonic()
    reaped = 0
    with _PENDING_LOCK:
        keep = []
        for ch, deadline in _PENDING:
            if force or now >= deadline:
                ch.destroy()
                reaped += 1
            else:
                keep.append((ch, deadline))
        _PENDING[:] = keep
    return reaped


def _named(deployment: str) -> Dict[str, str]:
    """The chaos site's ``deployment`` coordinate (the subject of the
    firing's flight event), when the request named one."""
    return {"deployment": deployment} if deployment else {}


def _observe(direction: str, deployment: str, seconds: float,
             nbytes: int, blocks: int) -> None:
    tags = {"deployment": deployment, "direction": direction}
    mdefs.SERVE_KV_TRANSFER_SECONDS.observe(seconds, tags=tags)
    mdefs.SERVE_KV_TRANSFER_BYTES.inc(max(int(nbytes), 0), tags=tags)
    mdefs.SERVE_KV_TRANSFER_BLOCKS.inc(max(int(blocks), 0), tags=tags)


def export_kv(engine, rid: int, *, deployment: str = "") -> Dict[str, Any]:
    """A parked request's payload from a prefill-role engine (staging
    bytes inline), with ``breakdown = {"export_s": seconds}``. The chaos
    site ``kv_transfer``/``stage=export`` fires before the gather, in the
    prefill replica's process. The caller holds the engine lock."""
    if chaos.enabled():
        chaos.inject("kv_transfer", stage="export", rid=rid,
                     **_named(deployment))
    t0 = time.perf_counter()
    payload = engine.export_kv_payload(rid)
    dt = time.perf_counter() - t0
    payload["breakdown"] = {"export_s": dt}
    _observe("export", deployment, dt, payload["nbytes"],
             payload["num_blocks"])
    return payload


def import_kv(engine, payload: Dict[str, Any], *,
              reservation: Optional[int] = None,
              trace: Optional[Dict[str, Any]] = None,
              deployment: str = "") -> int:
    """Land a payload in a decode-role engine (crc-checked, radix-indexed,
    its slot live). Returns the engine's id for the request. The chaos
    site ``kv_transfer``/``stage=import`` fires before the scatter, in
    the decode replica's process. The caller holds the engine lock."""
    if chaos.enabled():
        chaos.inject("kv_transfer", stage="import", rid=payload.get("rid"),
                     **_named(deployment))
    t0 = time.perf_counter()
    try:
        rid = engine.import_kv_payload(payload, reservation=reservation,
                                       trace=trace,
                                       breakdown=payload.get("breakdown"))
    except ValueError as e:
        if "crc" in str(e):
            mdefs.SERVE_HANDOFFS.inc(tags={
                "deployment": deployment, "outcome": "crc_mismatch"})
        raise
    _observe("import", deployment, time.perf_counter() - t0,
             payload.get("nbytes", 0), payload.get("num_blocks", 0))
    return rid


def send_handoff(engine, rid: int, *,
                 deployment: str = "") -> Dict[str, Any]:
    """Export and stage into a fresh shm channel. Returns the manifest:
    the payload without the staging bytes, plus the channel's reader
    attach-spec under ``"channel"``. The first write to a fresh channel
    never blocks, so the prefill replica is free once this returns. Not
    importable yet: the router journals the handoff and stamps
    ``manifest["journaled"]`` first."""
    from ray_tpu_torch.experimental.channel import Channel

    reap_channels()
    payload = export_kv(engine, rid, deployment=deployment)
    # The host bytes themselves (a pinned torch tensor would pickle as a
    # handle to shared storage, not as the bytes JAX's reader expects).
    staging = np.asarray(payload.pop(_BODY_KEY), dtype=np.uint8)
    t0 = time.perf_counter()
    ch = Channel(capacity=int(staging.nbytes) + (64 << 10), n_readers=1)
    ch.write(staging)
    dt = time.perf_counter() - t0
    with _PENDING_LOCK:
        _PENDING.append((ch, time.monotonic() + _channel_ttl_s()))
    payload["breakdown"]["channel_s"] = dt
    payload["channel"] = ch.reader(0)
    _observe("channel", deployment, dt, payload["nbytes"],
             payload["num_blocks"])
    return payload


def receive_handoff(engine, manifest: Dict[str, Any], *,
                    reservation: Optional[int] = None,
                    trace: Optional[Dict[str, Any]] = None,
                    deployment: str = "",
                    timeout_s: Optional[float] = None) -> int:
    """Collect a journaled handoff on the decode side: attach to the
    manifest's channel, read the staging bytes (``channel_s`` adds the
    read to the write), unlink the segment, and import. A manifest the
    router never journaled is refused: the journal gate is the
    exactly-once guarantee, so an unstamped manifest is a programming
    error, not a retryable one."""
    if not manifest.get("journaled"):
        raise RuntimeError(
            "KV handoff manifest was not journaled: every cross-replica "
            "transfer must pass through RequestJournal.note_handoff "
            "(DisaggRecoverableStream) before import")
    ch = manifest["channel"]
    t0 = time.perf_counter()
    try:
        staging = ch.read(timeout=timeout_s if timeout_s is not None
                          else transfer_timeout_s())
    finally:
        ch.destroy()          # consumed (or never coming): unlink it
    dt = time.perf_counter() - t0
    payload = {k: v for k, v in manifest.items()
               if k not in ("channel", "journaled")}
    payload[_BODY_KEY] = staging
    breakdown = dict(payload.get("breakdown") or {})
    breakdown["channel_s"] = breakdown.get("channel_s", 0.0) + dt
    payload["breakdown"] = breakdown
    _observe("channel", deployment, dt, payload.get("nbytes", 0),
             payload.get("num_blocks", 0))
    return import_kv(engine, payload, reservation=reservation,
                     trace=trace, deployment=deployment)


def transfer_inproc(src_engine, dst_engine, rid: int, *,
                    reservation: Optional[int] = None,
                    trace: Optional[Dict[str, Any]] = None,
                    deployment: str = "", journal=None) -> int:
    """Export from ``src_engine`` and import into ``dst_engine`` in one
    process, the staging buffer passed by reference. A ``journal``
    (anything with ``note_handoff`` and ``resumes``) notes the handoff as
    the cross-replica path does. Returns the decode engine's id."""
    payload = export_kv(src_engine, rid, deployment=deployment)
    if journal is not None:
        journal.note_handoff({
            "crc32": payload.get("crc32"),
            "nbytes": payload.get("nbytes"),
            "num_blocks": payload.get("num_blocks"),
            "attempt": journal.resumes,
        })
    return import_kv(dst_engine, payload, reservation=reservation,
                     trace=trace, deployment=deployment)

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
  when given one.

Each payload carries its ``breakdown`` (``export_s``, then ``import_s``),
which lands in the decode engine's request record.

Not ported yet (ROADMAP.md queue A, item 6c, the prefill/decode split
over the serve runtime): the shm channel between replicas
(:func:`send_handoff`, and :func:`receive_handoff` past its journal
gate), its reaper, and the ``kv_transfer`` chaos sites; the transfer
metrics (and the ``deployment`` tag they carry) wait for item 9.
"""

from __future__ import annotations

import os
import time
from typing import Any, Dict, Optional

from ray_tpu_torch.models import llama

__all__ = ["export_kv", "import_kv", "send_handoff", "receive_handoff",
           "transfer_inproc"]

_RUNTIME_ITEM = "item 6c (the prefill/decode split over the serve runtime)"


# The fault kinds JAX's chaos plans inject at this site.
_TRANSFER_FAULTS = {"kill_transfer", "delay_transfer"}


def _chaos_site(stage: str) -> None:
    """JAX injects ``RAY_TPU_CHAOS``'s transfer faults here; the port has
    no chaos harness yet, so a plan that asks for one raises rather than
    run without its faults."""
    kinds = {entry.split(":", 1)[0].strip()
             for entry in os.environ.get("RAY_TPU_CHAOS", "").split(";")}
    if kinds & _TRANSFER_FAULTS:
        raise llama.not_ported(f"the kv_transfer chaos site "
                               f"(stage={stage})", _RUNTIME_ITEM)


def export_kv(engine, rid: int) -> Dict[str, Any]:
    """A parked request's payload from a prefill-role engine (staging
    bytes inline), with ``breakdown = {"export_s": seconds}``."""
    _chaos_site("export")
    t0 = time.perf_counter()
    payload = engine.export_kv_payload(rid)
    payload["breakdown"] = {"export_s": time.perf_counter() - t0}
    return payload


def import_kv(engine, payload: Dict[str, Any], *,
              reservation: Optional[int] = None,
              trace: Optional[Dict[str, Any]] = None) -> int:
    """Land a payload in a decode-role engine (crc-checked, radix-indexed,
    its slot live). Returns the engine's id for the request."""
    _chaos_site("import")
    return engine.import_kv_payload(payload, reservation=reservation,
                                    trace=trace,
                                    breakdown=payload.get("breakdown"))


def send_handoff(engine, rid: int) -> Dict[str, Any]:
    """Export into a fresh shm channel: the channel between replicas is
    not ported yet (item 6c)."""
    raise llama.not_ported("send_handoff (the shm channel)", _RUNTIME_ITEM)


def receive_handoff(engine, manifest: Dict[str, Any], *,
                    reservation: Optional[int] = None,
                    trace: Optional[Dict[str, Any]] = None) -> int:
    """Collect a journaled handoff from its shm channel. A manifest the
    router never journaled is refused, as in JAX; past that gate the
    channel between replicas is not ported yet (item 6c)."""
    if not manifest.get("journaled"):
        raise RuntimeError(
            "KV handoff manifest was not journaled: every cross-replica "
            "transfer must pass through RequestJournal.note_handoff "
            "(DisaggRecoverableStream) before import")
    raise llama.not_ported("receive_handoff (the shm channel)",
                           _RUNTIME_ITEM)


def transfer_inproc(src_engine, dst_engine, rid: int, *,
                    reservation: Optional[int] = None,
                    trace: Optional[Dict[str, Any]] = None,
                    journal=None) -> int:
    """Export from ``src_engine`` and import into ``dst_engine`` in one
    process, the staging buffer passed by reference. A ``journal``
    (anything with ``note_handoff`` and ``resumes``) notes the handoff as
    the cross-replica path does. Returns the decode engine's id."""
    payload = export_kv(src_engine, rid)
    if journal is not None:
        journal.note_handoff({
            "crc32": payload.get("crc32"),
            "nbytes": payload.get("nbytes"),
            "num_blocks": payload.get("num_blocks"),
            "attempt": journal.resumes,
        })
    return import_kv(dst_engine, payload, reservation=reservation,
                     trace=trace)

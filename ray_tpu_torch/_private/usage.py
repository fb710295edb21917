"""Usage stats: which libraries a process used (the port of
``ray_tpu/_private/usage.py``).

As in JAX there is no network reporter: records aggregate in this
process, surfaced by :func:`usage_summary`, and are written to a local
JSON file under the temp dir (``ray_tpu_torch_usage_<pid>.json``, removed
when the process exits, or by the process that reaps it). Recording is
on by default; ``RAY_TPU_USAGE_STATS_ENABLED=0`` turns it off. A process
connected to a cluster also puts its record in the GCS KV, as JAX does
(namespace ``usage``, key ``worker/<pid>``).
"""

from __future__ import annotations

import atexit
import json
import os
import tempfile
import threading
import time
from typing import Any, Dict, Optional

_lock = threading.Lock()
_library_usages: set = set()
_extra_tags: Dict[str, str] = {}
_exit_hook = False                # the file's removal is registered


def usage_stats_enabled() -> bool:
    return os.environ.get("RAY_TPU_USAGE_STATS_ENABLED", "1") != "0"


def record_library_usage(name: str) -> None:
    """Mark a library (data, train, tune, serve, rllib, workflow) as used
    by this process."""
    if not usage_stats_enabled():
        return
    with _lock:
        if name in _library_usages:
            return
        _library_usages.add(name)
    _persist()


def record_extra_usage_tag(key: str, value: str) -> None:
    if not usage_stats_enabled():
        return
    with _lock:
        _extra_tags[key] = str(value)
    _persist()


def usage_summary() -> Dict[str, Any]:
    with _lock:
        return {
            "enabled": usage_stats_enabled(),
            "libraries": sorted(_library_usages),
            "extra_tags": dict(_extra_tags),
            "pid": os.getpid(),
        }


def _usage_path(pid: Optional[int] = None) -> str:
    return os.path.join(tempfile.gettempdir(),
                        f"ray_tpu_torch_usage_{pid or os.getpid()}.json")


def _persist() -> None:
    """Best-effort local record."""
    global _exit_hook
    summary = usage_summary()
    summary["ts"] = time.time()
    try:
        with open(_usage_path(), "w") as f:
            json.dump(summary, f)
    except OSError:
        return
    try:
        from ray_tpu_torch._private import messages as pb
        from ray_tpu_torch._private import worker as worker_mod

        w = worker_mod.global_worker_or_none()
        gcs = getattr(getattr(w, "core", None), "gcs", None)
        if gcs is not None:
            gcs.KvPut(pb.KvRequest(
                ns="usage", key=f"worker/{os.getpid()}",
                value=json.dumps(summary).encode(), overwrite=True))
    except Exception:  # noqa: BLE001 — a record is best-effort
        pass
    with _lock:
        if not _exit_hook:
            # A forked child inherits the hook, which removes its own
            # pid's file.
            atexit.register(lambda: remove_record(os.getpid()))
            _exit_hook = True


def remove_record(pid: Optional[int]) -> None:
    """Remove the file of process ``pid`` (at its exit, or when the
    process that reaps a killed replica process or fork server sees it
    go)."""
    if pid:
        try:
            os.remove(_usage_path(pid))
        except OSError:
            pass

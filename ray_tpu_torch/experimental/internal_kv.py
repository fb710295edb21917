"""Internal KV: the key/value store the libraries share (the port of
``ray_tpu/experimental/internal_kv.py``).

As in JAX, a process connected to a cluster
(``init(address=...)``) reads and writes the GCS KV, and under the
in-process runtime (or before any ``init``) a dict of this process under
a lock, keyed by ``(namespace, key)``. Both give JAX's results: ``put``
returns False when ``overwrite=False`` finds the key, ``get`` of a
missing key returns None, ``del`` returns whether the key was there, and
``list`` returns the keys of one namespace that start with a prefix.
"""

from __future__ import annotations

import threading
from typing import List, Optional

_local_kv = {}
_local_lock = threading.Lock()


def _gcs():
    """The GCS stub of this process's cluster runtime, or None."""
    from ray_tpu_torch._private import worker as _worker

    w = _worker.global_worker_or_none()
    return getattr(getattr(w, "core", None), "gcs", None)


def _internal_kv_put(key: str, value: bytes, overwrite: bool = True,
                     namespace: str = "default") -> bool:
    gcs = _gcs()
    if gcs is None:
        with _local_lock:
            if not overwrite and (namespace, key) in _local_kv:
                return False
            _local_kv[(namespace, key)] = bytes(value)
        return True
    from ray_tpu_torch._private import messages as pb

    return bool(gcs.KvPut(pb.KvRequest(ns=namespace, key=key,
                                       value=bytes(value),
                                       overwrite=overwrite)).ok)


def _internal_kv_get(key: str,
                     namespace: str = "default") -> Optional[bytes]:
    gcs = _gcs()
    if gcs is None:
        with _local_lock:
            return _local_kv.get((namespace, key))
    from ray_tpu_torch._private import messages as pb

    reply = gcs.KvGet(pb.KvRequest(ns=namespace, key=key))
    return bytes(reply.value) if reply.found else None


def _internal_kv_del(key: str, namespace: str = "default") -> bool:
    gcs = _gcs()
    if gcs is None:
        with _local_lock:
            return _local_kv.pop((namespace, key), None) is not None
    from ray_tpu_torch._private import messages as pb

    return bool(gcs.KvDel(pb.KvRequest(ns=namespace, key=key)).ok)


def _internal_kv_list(prefix: str = "",
                      namespace: str = "default") -> List[str]:
    gcs = _gcs()
    if gcs is None:
        with _local_lock:
            return [k for ns, k in _local_kv
                    if ns == namespace and k.startswith(prefix)]
    from ray_tpu_torch._private import messages as pb

    return list(gcs.KvKeys(pb.KvRequest(ns=namespace, prefix=prefix)).keys)


# Public aliases: both spellings are accepted, as in JAX.
internal_kv_put = _internal_kv_put
internal_kv_get = _internal_kv_get
internal_kv_del = _internal_kv_del
internal_kv_list = _internal_kv_list

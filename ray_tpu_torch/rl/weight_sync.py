"""RL weight-sync plane: trainer -> live generator replicas (the port of
``ray_tpu/rl/weight_sync.py``).

The trainer publishes a versioned manifest (per-leaf shape, dtype and
crc32, mirrored into a KV under ``__rl__``) after every N optimizer
steps; each generator replica holds a :class:`WeightSubscriber` that
reads the whole host-side param tree from a shared-memory channel
(:mod:`ray_tpu_torch.experimental.channel`). When the fast path is
unavailable (channel gone, crc mismatch, publisher dead) the subscriber
restores the crc32-verified checkpoint the publisher wrote alongside
(``checkpoint.load_latest``), so fast path == slow path bit for bit.

Backpressure is the channel's single-in-flight protocol: a publish waits
until every subscriber consumed the previous version, and past
``publish_timeout_s`` the publish SHEDS, naming the lagging reader
indices read from the channel header, rather than stalling the optimizer.

The tree is a nest of dicts and lists, flattened in ``jax.tree.leaves``
order (dict keys sorted, lists by index), so a manifest of converted params equals JAX's crc for crc: the
host leaves carry the same bytes (bf16 as its 16 bits; the port keeps no
``ml_dtypes``) and name the dtype as numpy does (``bfloat16``). On the
channel a leaf travels as a numpy array (bf16 as its uint16 view, so a
pickle writes it straight into the segment) and comes back as a host
tensor of the manifest's dtype.

The ``__rl__`` mirror goes to the KV the caller hands in: None (no
mirror, as JAX's without a runtime), a dict, or a ``torch.distributed``
store.
"""

from __future__ import annotations

import json
import logging
import time
import zlib
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

logger = logging.getLogger(__name__)

# KV namespace mirroring the manifest chain (keys ``<run>/manifest/
# <version>`` and ``<run>/latest``): any process with the KV can answer
# "what weight version is current for run X" without the channel.
RL_KV_NS = "__rl__"

# Params ride as one pickled payload; a publisher sizes its channel to
# the model's tree.
DEFAULT_CHANNEL_CAPACITY = 64 << 20


class WeightSyncError(RuntimeError):
    """A received payload failed manifest verification (crc/leaf-count)."""


# ------------------------------------------------------------ the tree
def _flat(tree, prefix: Tuple[Any, ...] = ()):
    """(key path, leaf) pairs of a nest of dicts and lists, in
    ``jax.tree.leaves`` order: dict keys sorted, list items by index (a
    list item's path element is its int index)."""
    if isinstance(tree, dict):
        items = ((k, tree[k]) for k in sorted(tree))
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return [(prefix, tree)]
    out = []
    for k, v in items:
        out.extend(_flat(v, prefix + (k,)))
    return out


def _nest(pairs) -> Any:
    """The nest :func:`_flat` flattened: an int path element makes a list
    (dict keys are strings)."""
    if len(pairs) == 1 and pairs[0][0] == ():
        return pairs[0][1]
    out: Dict[Any, Any] = {}
    for path, leaf in pairs:
        d = out
        for k in path[:-1]:
            d = d.setdefault(k, {})
        d[path[-1]] = leaf
    return _lists(out)


def _lists(node):
    if not isinstance(node, dict):
        return node
    if node and all(isinstance(k, int) for k in node):
        return [_lists(node[i]) for i in sorted(node)]
    return {k: _lists(v) for k, v in node.items()}


def _host_tensor(leaf) -> torch.Tensor:
    """A leaf as a contiguous host tensor (a copy of a device tensor)."""
    if isinstance(leaf, np.ndarray):
        return torch.from_numpy(np.ascontiguousarray(leaf))
    if not isinstance(leaf, torch.Tensor):
        return torch.from_numpy(np.asarray(leaf))
    return leaf.detach().to("cpu").contiguous()


def _host_tree(params: Any) -> Any:
    """The params as a nest of host tensors."""
    return _nest([(p, _host_tensor(x)) for p, x in _flat(params)])


def _host_leaves(params: Any) -> List[torch.Tensor]:
    """Host leaves in :func:`_flat`'s order (the manifest indexes leaves
    by this order on both sides)."""
    return [_host_tensor(x) for _, x in _flat(params)]


def _dtype_name(t: torch.Tensor) -> str:
    return str(t.dtype).replace("torch.", "")


def _raw(t: torch.Tensor) -> memoryview:
    """A host tensor's bytes, without a copy."""
    return memoryview(t.reshape(-1).view(torch.uint8).numpy())


def _crc(t: torch.Tensor) -> int:
    return zlib.crc32(_raw(t))


def _wire(tree: Any) -> Any:
    """Host tensors -> numpy for the channel (bf16 as its uint16 bits)."""
    return _nest([(p, (t.view(torch.uint16) if t.dtype == torch.bfloat16
                       else t).numpy()) for p, t in _flat(tree)])


def _from_wire(tree: Any, manifest: Dict[str, Any]) -> Any:
    """The channel's numpy nest -> host tensors of the manifest's dtypes."""
    pairs = _flat(tree)
    specs = manifest.get("leaves", [])
    out = []
    for i, (p, a) in enumerate(pairs):
        t = torch.from_numpy(a)
        if i < len(specs) and specs[i]["dtype"] == "bfloat16":
            t = t.view(torch.bfloat16)
        out.append((p, t))
    return _nest(out)


def build_manifest(run: str, version: int, step: int, leaves: List[Any],
                   ckpt_root: Optional[str] = None,
                   ckpt_run: Optional[str] = None) -> Dict[str, Any]:
    """Versioned weight manifest: per-leaf shape/dtype/crc32 and the slow
    path's pointer (checkpoint plane root/run) the fallback ladder ends
    at. ``leaves``: host tensors or numpy arrays, in the tree's order."""
    leaves = [_host_tensor(a) for a in leaves]
    return {
        "run": run,
        "version": int(version),
        "step": int(step),
        "ts": time.time(),
        "leaves": [{
            "shape": list(a.shape),
            "dtype": _dtype_name(a),
            "crc32": _crc(a),
        } for a in leaves],
        "bytes": int(sum(a.numel() * a.element_size() for a in leaves)),
        "ckpt_root": ckpt_root,
        "ckpt_run": ckpt_run,
    }


def verify_manifest(manifest: Dict[str, Any], leaves: List[Any]) -> None:
    """Integrity gate on arrival: leaf count and per-leaf crc32 against the
    manifest. Raises :class:`WeightSyncError`: the caller's cue to drop
    the payload and take the checkpoint fallback."""
    specs = manifest.get("leaves", [])
    if len(specs) != len(leaves):
        raise WeightSyncError(
            f"weight payload has {len(leaves)} leaves but manifest "
            f"v{manifest.get('version')} declares {len(specs)}")
    for i, (spec, leaf) in enumerate(zip(specs, leaves)):
        crc = _crc(_host_tensor(leaf))
        if crc != spec["crc32"]:
            raise WeightSyncError(
                f"leaf {i} crc mismatch for weight version "
                f"{manifest.get('version')}: got {crc:#010x}, manifest "
                f"says {spec['crc32']:#010x}")


# ---------------------------------------------------------------- the KV
class _RLKV:
    """``put``/``get`` of the ``__rl__`` keys in a dict or a store."""

    def __init__(self, kv):
        from ray_tpu_torch.checkpoint.plane import DictKV, StoreKV

        if isinstance(kv, dict):
            self._kv, self._prefix = DictKV(kv), RL_KV_NS + "/"
        elif isinstance(kv, torch.distributed.Store):
            self._kv, self._prefix = StoreKV(kv, RL_KV_NS), ""
        else:
            self._kv, self._prefix = kv, RL_KV_NS + "/"

    def put(self, key: str, value: bytes) -> None:
        self._kv.put(self._prefix + key, value, overwrite=True)

    def get(self, key: str) -> Optional[bytes]:
        return self._kv.get(self._prefix + key)


def _as_kv(kv) -> Optional[_RLKV]:
    return None if kv is None else _RLKV(kv)


def _kv_put_manifest(kv: Optional[_RLKV], manifest: Dict[str, Any]) -> None:
    if kv is None:
        return
    try:
        run, version = manifest["run"], manifest["version"]
        raw = json.dumps(manifest).encode()
        kv.put(f"{run}/manifest/{version:010d}", raw)
        kv.put(f"{run}/latest", raw)
    except Exception:  # noqa: BLE001 - mirroring is best-effort
        logger.debug("rl: KV manifest mirror failed", exc_info=True)


def latest_manifest(run: str, kv=None) -> Optional[Dict[str, Any]]:
    """Newest published manifest for ``run`` from the ``__rl__`` mirror in
    ``kv`` (``None`` with no KV or no publish yet)."""
    kv = kv if isinstance(kv, _RLKV) else _as_kv(kv)
    if kv is None:
        return None
    try:
        raw = kv.get(f"{run}/latest")
        return json.loads(raw) if raw else None
    except Exception:  # noqa: BLE001
        return None


# ----------------------------------------------------------- publisher
class WeightPublisher:
    """Trainer-side half of the sync plane.

    Owns the channel (created at once, so subscriber attach-specs exist
    before the first publish) and the version counter. ``publish_every``
    turns :meth:`maybe_publish` into the "every N optimizer steps" gate;
    ``ckpt_plane`` (a ``CheckpointPlane``) makes every publish also save
    the checkpoint that backs the slow path. ``capacity`` bounds one
    pickled payload (the tree's bytes plus a little).
    """

    def __init__(self, run: str = "rl", n_subscribers: int = 1,
                 capacity: int = DEFAULT_CHANNEL_CAPACITY,
                 publish_every: int = 1,
                 publish_timeout_s: float = 5.0,
                 ckpt_plane: Any = None, kv=None):
        from ray_tpu_torch.experimental.channel import Channel

        self.run = run
        self.publish_every = max(int(publish_every), 1)
        self.publish_timeout_s = float(publish_timeout_s)
        self.ckpt_plane = ckpt_plane
        self.version = 0
        self._steps_since = 0
        self._kv = _as_kv(kv)
        self._chan = Channel(capacity=capacity, n_readers=n_subscribers)
        self._mtags = {"run": run}
        # The newest publish's split: {"save_s", "write_s", "host_s"}.
        self.last_timing: Dict[str, float] = {}

    def subscriber_spec(self, idx: int):
        """Picklable attach-spec for subscriber ``idx``: ship it into the
        generator replica and hand it to :class:`WeightSubscriber`."""
        return self._chan.reader(idx)

    def maybe_publish(self, params: Any, step: int,
                      cause: str = "") -> Optional[Dict[str, Any]]:
        """Publish iff ``publish_every`` optimizer steps elapsed since the
        last publish. Returns the manifest when one went out."""
        self._steps_since += 1
        if self._steps_since < self.publish_every:
            return None
        self._steps_since = 0
        return self.publish(params, step, cause=cause)

    def publish(self, params: Any, step: int,
                cause: str = "") -> Dict[str, Any]:
        """Version, checksum, mirror, checkpoint, and push one weight
        snapshot. On subscriber backpressure past the timeout the publish
        is SHED (``manifest["shed"]`` lists the lagging reader indices)
        instead of blocking the optimizer."""
        from ray_tpu_torch._private import events as _events
        from ray_tpu_torch._private import metrics_defs as mdefs

        t0 = time.perf_counter()
        self.version += 1
        host_params = _host_tree(params)
        leaves = [t for _, t in _flat(host_params)]
        manifest = build_manifest(
            self.run, self.version, step, leaves,
            ckpt_root=getattr(self.ckpt_plane, "root", None),
            ckpt_run=getattr(self.ckpt_plane, "run", None))
        t1 = time.perf_counter()
        if self.ckpt_plane is not None:
            # Slow-path source of truth, saved BEFORE the channel push so
            # a subscriber that misses the fast path never sees a version
            # without a checkpoint.
            self.ckpt_plane.save(self.version, host_params)
        t2 = time.perf_counter()
        _kv_put_manifest(self._kv, manifest)
        event_id = _events.emit(
            "rl.manifest_publish", cause=cause,
            subject={"run": self.run},
            version=self.version, step=int(step),
            bytes=manifest["bytes"])
        manifest["event_id"] = event_id
        try:
            self._chan.write((manifest, _wire(host_params)),
                             timeout=self.publish_timeout_s)
        except Exception as e:  # noqa: BLE001 - shed, don't stall training
            lagging = self.lagging_subscribers()
            manifest["shed"] = lagging or [-1]
            for idx in (lagging or [-1]):
                mdefs.RL_SYNC_SHED.inc(
                    tags={"run": self.run, "subscriber": str(idx)})
            _events.emit("rl.publish_shed", cause=event_id,
                         subject={"run": self.run},
                         version=self.version, lagging=str(lagging),
                         error=type(e).__name__)
            logger.warning(
                "rl: publish v%d shed (lagging subscribers %s): %s",
                self.version, lagging, e)
        else:
            mdefs.RL_SYNC_BYTES.inc(manifest["bytes"],
                                    tags={**self._mtags, "path": "publish"})
        t3 = time.perf_counter()
        self.last_timing = {"host_s": t1 - t0, "save_s": t2 - t1,
                            "write_s": t3 - t2}
        mdefs.RL_SYNC_SECONDS.observe(t3 - t0, tags={**self._mtags,
                                                     "path": "publish"})
        mdefs.RL_VERSION.set(self.version,
                             tags={**self._mtags, "role": "trainer"})
        return manifest

    def lagging_subscribers(self) -> List[int]:
        """Subscriber indices that have not acked the latest channel
        version: the shed's attribution."""
        try:
            return self._chan.lagging_readers()
        except Exception:  # noqa: BLE001
            return []

    def close(self) -> None:
        try:
            self._chan.close()
        except Exception:  # noqa: BLE001
            pass

    def destroy(self) -> None:
        try:
            self._chan.destroy()
        except Exception:  # noqa: BLE001
            pass


# ----------------------------------------------------------- subscriber
class WeightSubscriber:
    """Generator-side half: non-blocking poll for the next published
    version, crc-verified, with the checkpoint as the fallback ladder's
    last rung. Params come back as a host tree; the deployment moves them
    to its card at the swap. ``spec`` may be None for a subscriber that
    only restores (a respawned replica brought current). ``kv``: where
    :meth:`restore_fallback` finds the newest manifest when it is handed
    none."""

    def __init__(self, spec: Any, run: str = "rl",
                 target_shardings: Any = None, kv=None):
        if target_shardings is not None:
            from ray_tpu_torch.models.llama import not_ported

            raise not_ported("WeightSubscriber(target_shardings=...) (a "
                             "generator's params placed on a mesh)",
                             "item 10b")
        self.run = run
        self._chan = spec
        self._kv = _as_kv(kv)
        self.version = 0
        self._mtags = {"run": run}
        # The newest receive's split: {"read_s", "crc_s"}.
        self.last_timing: Dict[str, float] = {}

    def poll(self, timeout: float = 0.05
             ) -> Optional[Tuple[Dict[str, Any], Any]]:
        """One fast-path receive attempt. Returns ``(manifest, params)``
        when a fresh verified version arrived, ``None`` on timeout.
        Raises :class:`WeightSyncError` on verification failure and
        ``ChannelClosed`` when the publisher is gone: both are the
        caller's cue to fall back to :meth:`restore_fallback`."""
        from ray_tpu_torch._private import metrics_defs as mdefs
        from ray_tpu_torch.experimental.channel import ChannelTimeout

        if self._chan is None:
            raise WeightSyncError("this subscriber has no channel")
        t0 = time.perf_counter()
        try:
            manifest, wire = self._chan.read(timeout=timeout)
        except ChannelTimeout:
            return None
        params = _from_wire(wire, manifest)
        t1 = time.perf_counter()
        verify_manifest(manifest, _host_leaves(params))
        t2 = time.perf_counter()
        self.last_timing = {"read_s": t1 - t0, "crc_s": t2 - t1}
        self.version = int(manifest["version"])
        mdefs.RL_SYNC_BYTES.inc(manifest["bytes"],
                                tags={**self._mtags, "path": "subscribe"})
        mdefs.RL_SYNC_SECONDS.observe(t2 - t0, tags={**self._mtags,
                                                     "path": "subscribe"})
        return manifest, params

    def restore_fallback(self, manifest: Optional[Dict[str, Any]] = None
                         ) -> Tuple[Dict[str, Any], Any]:
        """Slow path: restore the manifest's version from its checkpoint
        (``load_latest``: crc32-verified, filesystem only). With no
        manifest in hand, the ``__rl__`` mirror in this subscriber's KV
        supplies the newest one."""
        from ray_tpu_torch._private import metrics_defs as mdefs
        from ray_tpu_torch.checkpoint import load_latest

        t0 = time.perf_counter()
        if manifest is None:
            manifest = latest_manifest(self.run, self._kv)
        if not manifest or not manifest.get("ckpt_root"):
            raise WeightSyncError(
                f"no checkpoint fallback available for run {self.run!r} "
                f"(manifest={manifest})")
        params = load_latest(manifest["ckpt_root"],
                             run=manifest.get("ckpt_run"),
                             step=int(manifest["version"]))
        params = getattr(params, "params", params)
        t1 = time.perf_counter()
        verify_manifest(manifest, _host_leaves(params))
        t2 = time.perf_counter()
        self.last_timing = {"read_s": t1 - t0, "crc_s": t2 - t1}
        self.version = int(manifest["version"])
        mdefs.RL_SYNC_BYTES.inc(manifest["bytes"],
                                tags={**self._mtags, "path": "fallback"})
        mdefs.RL_SYNC_SECONDS.observe(t2 - t0, tags={**self._mtags,
                                                     "path": "fallback"})
        return manifest, params


__all__ = [
    "DEFAULT_CHANNEL_CAPACITY", "RL_KV_NS", "WeightPublisher",
    "WeightSubscriber", "WeightSyncError", "build_manifest",
    "latest_manifest", "verify_manifest",
]

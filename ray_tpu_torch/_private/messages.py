"""The wire's messages: one class per message of JAX's
``ray_tpu/protobuf/ray_tpu.proto`` that its three control services use
(``GcsService`` :224, ``NodeService`` :328, ``WorkerService`` :412).

The card's machine has no protobuf and no schema of the port's, so the
port keeps the proto's messages as plain Python classes built from the
table below (same names, same fields, same proto3 defaults: ``""``,
``b""``, ``0``, ``False``, an empty list or dict, an empty submessage),
pickled on the wire (:mod:`ray_tpu_torch._private.rpc`). What the JAX
code calls on a message, the classes offer: keyword construction,
attribute access, ``add()`` on a repeated submessage field,
``SerializeToString``, ``FromString`` and ``CopyFrom``. One field is renamed: ``tpu_chips`` (``TaskSpec`` and
``LeaseReply``) is ``card_ids``, the CUDA card ids a lease grants.
"""

from __future__ import annotations

import pickle
from typing import Any, Dict, Tuple

_SCHEMA = {
    "Empty": (),
    "NodeInfo": (("node_id", "scalar", ""), ("address", "scalar", ""), ("alive", "scalar", False), ("resources", "map", None), ("available", "map", None), ("labels", "map", None), ("object_store_address", "scalar", ""), ("heartbeat_ms", "scalar", 0), ("fast_address", "scalar", "")),
    "ActorInfo": (("actor_id", "scalar", b""), ("name", "scalar", ""), ("namespace", "scalar", ""), ("class_name", "scalar", ""), ("state", "scalar", ""), ("address", "scalar", ""), ("node_id", "scalar", ""), ("num_restarts", "scalar", 0), ("max_restarts", "scalar", 0), ("spec", "scalar", b""), ("death_cause", "scalar", ""), ("fast_address", "scalar", "")),
    "TaskSpec": (("task_id", "scalar", b""), ("name", "scalar", ""), ("payload", "scalar", b""), ("return_ids", "list", None), ("resources", "map", None), ("actor_id", "scalar", b""), ("method_name", "scalar", ""), ("max_retries", "scalar", 0), ("caller_address", "scalar", b""), ("sequence_no", "scalar", 0), ("card_ids", "list", None), ("runtime_env", "scalar", b""), ("placement_group_id", "scalar", b""), ("pg_bundle_index", "scalar", 0), ("pg_capture_child_tasks", "scalar", False), ("affinity_node_id", "scalar", ""), ("affinity_soft", "scalar", False), ("strategy", "scalar", ""), ("payload_ref", "scalar", b""), ("trace_id", "scalar", ""), ("parent_span_id", "scalar", ""), ("returns_stream", "scalar", False), ("label_selector", "scalar", b""), ("cancelled", "scalar", False)),
    "RegisterNodeRequest": (("info", "msg", "NodeInfo"),),
    "RegisterNodeReply": (("ok", "scalar", False),),
    "DrainNodeRequest": (("node_id", "scalar", ""),),
    "HeartbeatRequest": (("node_id", "scalar", ""), ("available", "map", None), ("seq", "scalar", 0)),
    "HeartbeatReply": (("ok", "scalar", False),),
    "GetNodesRequest": (),
    "GetNodesReply": (("nodes", "msgs", "NodeInfo"),),
    "KvRequest": (("ns", "scalar", ""), ("key", "scalar", ""), ("value", "scalar", b""), ("overwrite", "scalar", False), ("prefix", "scalar", "")),
    "KvReply": (("found", "scalar", False), ("value", "scalar", b""), ("keys", "list", None), ("ok", "scalar", False)),
    "RegisterActorRequest": (("info", "msg", "ActorInfo"),),
    "RegisterActorReply": (("ok", "scalar", False), ("error", "scalar", "")),
    "UpdateActorRequest": (("info", "msg", "ActorInfo"),),
    "GetActorRequest": (("actor_id", "scalar", b""), ("name", "scalar", ""), ("namespace", "scalar", "")),
    "GetActorReply": (("found", "scalar", False), ("info", "msg", "ActorInfo")),
    "ListActorsRequest": (("namespace", "scalar", ""), ("all_namespaces", "scalar", False)),
    "ListActorsReply": (("actors", "msgs", "ActorInfo"),),
    "PublishRequest": (("channel", "scalar", ""), ("data", "scalar", b"")),
    "SubscribeRequest": (("channels", "list", None), ("subscriber_id", "scalar", "")),
    "PubsubMessage": (("channel", "scalar", ""), ("data", "scalar", b"")),
    "Bundle": (("index", "scalar", 0), ("resources", "map", None), ("node_id", "scalar", "")),
    "CreatePlacementGroupRequest": (("group_id", "scalar", b""), ("name", "scalar", ""), ("strategy", "scalar", ""), ("bundles", "msgs", "Bundle")),
    "PlacementGroupInfo": (("group_id", "scalar", b""), ("name", "scalar", ""), ("strategy", "scalar", ""), ("bundles", "msgs", "Bundle"), ("state", "scalar", "")),
    "GetPlacementGroupRequest": (("group_id", "scalar", b""),),
    "GetPlacementGroupReply": (("found", "scalar", False), ("info", "msg", "PlacementGroupInfo")),
    "RemovePlacementGroupRequest": (("group_id", "scalar", b""),),
    "ObjectLocationUpdate": (("object_id", "scalar", b""), ("node_id", "scalar", ""), ("added", "scalar", False), ("size", "scalar", 0)),
    "GetObjectLocationsRequest": (("object_id", "scalar", b""),),
    "GetObjectsMetaRequest": (("object_ids", "list", None),),
    "GetObjectsMetaReply": (("found", "list", None),),
    "GetObjectLocationsReply": (("node_ids", "list", None), ("size", "scalar", 0), ("freed", "scalar", False)),
    "RefCountDelta": (("object_id", "scalar", b""), ("delta", "scalar", 0)),
    "UpdateRefCountsRequest": (("holder_id", "scalar", ""), ("deltas", "msgs", "RefCountDelta"), ("node_id", "scalar", ""), ("is_driver", "scalar", False)),
    "ReapHolderRequest": (("holder_id", "scalar", ""),),
    "LeaseRequest": (("spec", "msg", "TaskSpec"), ("caller", "scalar", "")),
    "LeaseReply": (("granted", "scalar", False), ("worker_address", "scalar", ""), ("worker_id", "scalar", ""), ("spillback_node_id", "scalar", ""), ("spillback_address", "scalar", ""), ("error", "scalar", ""), ("card_ids", "list", None), ("worker_fast_address", "scalar", "")),
    "ReturnWorkerRequest": (("worker_id", "scalar", ""), ("lease_id", "scalar", b"")),
    "PrepareBundleRequest": (("group_id", "scalar", b""), ("bundles", "msgs", "Bundle")),
    "PrepareBundleReply": (("success", "scalar", False),),
    "CommitBundleRequest": (("group_id", "scalar", b""), ("bundles", "msgs", "Bundle")),
    "CancelBundleRequest": (("group_id", "scalar", b""),),
    "CreateActorOnNodeRequest": (("info", "msg", "ActorInfo"),),
    "CreateActorOnNodeReply": (("ok", "scalar", False), ("worker_address", "scalar", ""), ("error", "scalar", ""), ("fast_address", "scalar", "")),
    "PullObjectRequest": (("object_id", "scalar", b""),),
    "ObjectChunk": (("object_id", "scalar", b""), ("total_size", "scalar", 0), ("offset", "scalar", 0), ("data", "scalar", b""), ("eof", "scalar", False), ("found", "scalar", False)),
    "FreeObjectsRequest": (("object_ids", "list", None),),
    "AnnounceWorkerRequest": (("worker_id", "scalar", ""), ("address", "scalar", ""), ("pid", "scalar", 0), ("fast_address", "scalar", "")),
    "PutObjectRequest": (("object_id", "scalar", b""), ("data", "scalar", b""), ("owner", "scalar", ""), ("shm_name", "scalar", ""), ("size", "scalar", 0)),
    "PutObjectBatchRequest": (("items", "msgs", "PutObjectRequest"),),
    "PutObjectBatchReply": (("rejected", "list", None),),
    "PutObjectReply": (("rejected", "scalar", False),),
    "ObjectLocationBatch": (("updates", "msgs", "ObjectLocationUpdate"),),
    "GetObjectRequest": (("object_id", "scalar", b""), ("metadata_only", "scalar", False)),
    "GetObjectReply": (("found", "scalar", False), ("data", "scalar", b""), ("shm_name", "scalar", ""), ("size", "scalar", 0)),
    "PushTaskRequest": (("spec", "msg", "TaskSpec"),),
    "KillActorRequest": (("actor_id", "scalar", b""), ("no_restart", "scalar", False)),
    "WorkerStacktraceRequest": (),
    "WorkerStacktraceReply": (("stacktrace", "scalar", ""),),
    "CreateActorRequest": (("info", "msg", "ActorInfo"), ("env", "map", None)),
    "CreateActorReply": (("ok", "scalar", False), ("error", "scalar", "")),
    "PushTaskResult": (("ok", "scalar", False), ("inline_results", "list", None), ("in_store", "list", None), ("error", "scalar", b"")),
    "CancelTaskRequest": (("task_id", "scalar", b""), ("force", "scalar", False), ("recursive", "scalar", False)),
    "CancelTaskReply": (("found", "scalar", False),),
    "PushTaskBatchRequest": (("specs", "msgs", "TaskSpec"),),
    "PushTaskBatchReply": (("results", "msgs", "PushTaskResult"),),
}

# Each service's methods: request, reply, server-streamed.
SERVICES = {
    "GcsService": {
        "RegisterNode": ("RegisterNodeRequest", "RegisterNodeReply", False),
        "DrainNode": ("DrainNodeRequest", "Empty", False),
        "Heartbeat": ("HeartbeatRequest", "HeartbeatReply", False),
        "GetNodes": ("GetNodesRequest", "GetNodesReply", False),
        "KvPut": ("KvRequest", "KvReply", False),
        "KvGet": ("KvRequest", "KvReply", False),
        "KvDel": ("KvRequest", "KvReply", False),
        "KvKeys": ("KvRequest", "KvReply", False),
        "RegisterActor": ("RegisterActorRequest", "RegisterActorReply", False),
        "UpdateActor": ("UpdateActorRequest", "Empty", False),
        "GetActor": ("GetActorRequest", "GetActorReply", False),
        "ListActors": ("ListActorsRequest", "ListActorsReply", False),
        "Publish": ("PublishRequest", "Empty", False),
        "Subscribe": ("SubscribeRequest", "PubsubMessage", True),
        "CreatePlacementGroup": ("CreatePlacementGroupRequest", "Empty", False),
        "GetPlacementGroup": ("GetPlacementGroupRequest", "GetPlacementGroupReply", False),
        "RemovePlacementGroup": ("RemovePlacementGroupRequest", "Empty", False),
        "UpdateObjectLocation": ("ObjectLocationUpdate", "Empty", False),
        "UpdateObjectLocationsBatch": ("ObjectLocationBatch", "Empty", False),
        "GetObjectLocations": ("GetObjectLocationsRequest", "GetObjectLocationsReply", False),
        "GetObjectsLocations": ("GetObjectsMetaRequest", "GetObjectsMetaReply", False),
        "UpdateRefCounts": ("UpdateRefCountsRequest", "Empty", False),
        "ReapHolder": ("ReapHolderRequest", "Empty", False),
    },
    "NodeService": {
        "RequestWorkerLease": ("LeaseRequest", "LeaseReply", False),
        "ReturnWorker": ("ReturnWorkerRequest", "Empty", False),
        "CreateActorOnNode": ("CreateActorOnNodeRequest", "CreateActorOnNodeReply", False),
        "AnnounceWorker": ("AnnounceWorkerRequest", "Empty", False),
        "PrepareBundle": ("PrepareBundleRequest", "PrepareBundleReply", False),
        "CommitBundle": ("CommitBundleRequest", "Empty", False),
        "CancelBundle": ("CancelBundleRequest", "Empty", False),
        "PutObject": ("PutObjectRequest", "PutObjectReply", False),
        "PutObjectBatch": ("PutObjectBatchRequest", "PutObjectBatchReply", False),
        "GetObject": ("GetObjectRequest", "GetObjectReply", False),
        "GetObjectsMeta": ("GetObjectsMetaRequest", "GetObjectsMetaReply", False),
        "PullObject": ("PullObjectRequest", "ObjectChunk", True),
        "FreeObjects": ("FreeObjectsRequest", "Empty", False),
    },
    "WorkerService": {
        "PushTask": ("PushTaskRequest", "PushTaskResult", False),
        "PushTaskBatch": ("PushTaskBatchRequest", "PushTaskBatchReply", False),
        "CreateActor": ("CreateActorRequest", "CreateActorReply", False),
        "KillActor": ("KillActorRequest", "Empty", False),
        "CancelTask": ("CancelTaskRequest", "CancelTaskReply", False),
        "Stacktrace": ("WorkerStacktraceRequest", "WorkerStacktraceReply", False),
    },
}

class _Repeated(list):
    """A repeated submessage field: a list with ``add(**fields)``."""

    __slots__ = ("_cls",)

    def __init__(self, cls, items=()):
        super().__init__(items)
        self._cls = cls

    def add(self, **fields):
        msg = self._cls(**fields)
        self.append(msg)
        return msg

    def __reduce__(self):
        return list, (list(self),)


def _rebuild(cls, values):
    msg = object.__new__(cls)
    for (name, kind, arg), value in zip(cls._FIELDS, values):
        if kind == "msgs":
            value = _Repeated(_CLASSES[arg], value)
        object.__setattr__(msg, name, value)
    return msg


class Message:
    """Base of every message class; ``_FIELDS`` is its row of the table."""

    __slots__ = ()
    _FIELDS: Tuple = ()

    def __init__(self, **fields):
        for name, kind, arg in self._FIELDS:
            value = fields.pop(name, None)
            if kind == "scalar":
                value = arg if value is None else value
            elif kind == "list":
                value = list(value or ())
            elif kind == "map":
                value = dict(value or {})
            elif kind == "msg":
                value = _CLASSES[arg]() if value is None else value
            else:
                value = _Repeated(_CLASSES[arg], value or ())
            object.__setattr__(self, name, value)
        if fields:
            raise TypeError(f"{type(self).__name__} has no field(s) "
                            f"{sorted(fields)}")

    def __reduce__(self):
        return _rebuild, (type(self), tuple(
            getattr(self, name) for name, _, _ in self._FIELDS))

    def __eq__(self, other):
        return type(other) is type(self) and all(
            getattr(self, n) == getattr(other, n) for n, _, _ in self._FIELDS)

    def __repr__(self):
        body = ", ".join(f"{n}={getattr(self, n)!r}"
                         for n, _, _ in self._FIELDS)
        return f"{type(self).__name__}({body})"

    def SerializeToString(self) -> bytes:  # noqa: N802 — protobuf's name
        return pickle.dumps(self, protocol=5)

    @classmethod
    def FromString(cls, data):  # noqa: N802
        msg = pickle.loads(data)
        if type(msg) is not cls:
            raise TypeError(f"expected {cls.__name__}, got "
                            f"{type(msg).__name__}")
        return msg

    def CopyFrom(self, other) -> None:  # noqa: N802
        other = pickle.loads(pickle.dumps(other, protocol=5))
        for name, _, _ in self._FIELDS:
            object.__setattr__(self, name, getattr(other, name))


_CLASSES: Dict[str, Any] = {}
for _name, _fields in _SCHEMA.items():
    _CLASSES[_name] = type(_name, (Message,), {
        "__slots__": tuple(f[0] for f in _fields), "_FIELDS": _fields,
        "__module__": __name__, "__qualname__": _name})
globals().update(_CLASSES)
del _name, _fields

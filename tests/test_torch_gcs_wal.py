"""The GCS's write-ahead log held to JAX's: one mutation sequence (KV puts
and deletes, actor registrations and updates, a placement group created
and removed, object locations added and removed one at a time and in
batches) goes through JAX's ``GcsServer`` and the port's, each persisting
through its ``WriteAheadLog``, with a compaction forced halfway. A second
server of each package then recovers from the snapshot plus the log
alone (the first never shut down, as after a crash), and the recovered
tables must be equal between the two packages and to the live ones.
"""

import pickle

import pytest

SEQUENCE_HALF = 40


def _ops(n, start=0):
    """The mutation sequence: ``(op, args)`` tuples, deterministic."""
    out = []
    for i in range(start, start + n):
        k = i % 7
        if k == 0:
            out.append(("kv_put", (f"ns{i % 3}", f"key{i % 11}",
                                   f"v{i}".encode())))
        elif k == 1:
            out.append(("kv_del", (f"ns{(i + 1) % 3}", f"key{(i * 5) % 11}")))
        elif k == 2:
            out.append(("actor", (bytes([i % 9]) * 16, f"a{i % 4}"
                                  if i % 2 else "", "ALIVE", i % 3)))
        elif k == 3:
            out.append(("actor", (bytes([(i + 4) % 9]) * 16, "", "DEAD",
                                  1)))
        elif k == 4:
            out.append(("loc", (bytes([i % 13]) * 28, f"node{i % 3}",
                                i % 5 != 0, 100 + i)))
        elif k == 5:
            out.append(("locs", [(bytes([(i + j) % 13]) * 28, f"node{j}",
                                  True, 10 * j) for j in range(3)]))
        else:
            out.append(("pg", (bytes([i % 5]) * 16, f"pg{i}")))
    return out


def _apply(gcs, pb, ops):
    for op, args in ops:
        if op == "kv_put":
            ns, key, value = args
            gcs.KvPut(pb.KvRequest(ns=ns, key=key, value=value,
                                   overwrite=True), None)
        elif op == "kv_del":
            gcs.KvDel(pb.KvRequest(ns=args[0], key=args[1]), None)
        elif op == "actor":
            aid, name, state, restarts = args
            info = pb.ActorInfo(actor_id=aid, name=name, namespace="default",
                                class_name="C", state=state,
                                num_restarts=restarts, max_restarts=3,
                                spec=pickle.dumps({"resources": {}}))
            if aid in gcs._actors:
                gcs.UpdateActor(pb.UpdateActorRequest(info=info), None)
            else:
                gcs.RegisterActor(pb.RegisterActorRequest(info=info), None)
        elif op == "loc":
            oid, node, added, size = args
            gcs.UpdateObjectLocation(pb.ObjectLocationUpdate(
                object_id=oid, node_id=node, added=added, size=size), None)
        elif op == "locs":
            batch = pb.ObjectLocationBatch()
            for oid, node, added, size in args:
                batch.updates.append(pb.ObjectLocationUpdate(
                    object_id=oid, node_id=node, added=added, size=size))
            gcs.UpdateObjectLocationsBatch(batch, None)
        else:
            gid, name = args
            req = pb.CreatePlacementGroupRequest(group_id=gid, name=name,
                                                 strategy="PACK")
            b = req.bundles.add()
            b.index = 0
            b.resources["CPU"] = 1.0
            gcs.CreatePlacementGroup(req, None)
            gcs.RemovePlacementGroup(
                pb.RemovePlacementGroupRequest(group_id=gid), None)


def _tables(gcs):
    with gcs._lock:
        return {
            "kv": dict(gcs._kv),
            "actors": {bytes(k): (a.name, a.namespace, a.state,
                                  a.num_restarts, a.max_restarts,
                                  bytes(a.spec))
                       for k, a in gcs._actors.items()},
            "names": dict(gcs._actor_names),
            "pgroups": {bytes(k): (g.name, g.strategy, g.state,
                                   [(b.index, dict(b.resources), b.node_id)
                                    for b in g.bundles])
                        for k, g in gcs._pgroups.items()},
            "locations": {k: sorted(v) for k, v in gcs._locations.items()
                          if v},
            "sizes": dict(gcs._object_sizes),
        }


def _run(server_cls, pb, path):
    live = server_cls(port=0, persist_path=str(path))
    try:
        _apply(live, pb, _ops(SEQUENCE_HALF))
        assert live.wal_sync(30.0)
        live._wal._compact()              # the snapshot, then a fresh log
        _apply(live, pb, _ops(SEQUENCE_HALF, start=SEQUENCE_HALF))
        assert live.wal_sync(30.0)
        want = _tables(live)
        # A second server reads the snapshot and replays the log, as after
        # the first one's crash.
        recovered = server_cls(port=0, persist_path=str(path))
        try:
            got = _tables(recovered)
        finally:
            recovered.shutdown()
    finally:
        live.shutdown()
    return want, got


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    from ray_tpu._private.gcs.server import GcsServer as JaxGcs
    from ray_tpu.protobuf import ray_tpu_pb2 as jpb

    from ray_tpu_torch._private import messages as tpb
    from ray_tpu_torch._private.gcs.server import GcsServer as PortGcs

    root = tmp_path_factory.mktemp("wal")
    return (_run(PortGcs, tpb, root / "port_state"),
            _run(JaxGcs, jpb, root / "jax_state"))


@pytest.mark.parametrize("table", ["kv", "actors", "names", "pgroups",
                                   "locations", "sizes"])
def test_recovered_tables_equal_jax_and_live(both, table):
    (port_live, port_got), (jax_live, jax_got) = both
    assert port_got[table] == port_live[table]
    assert jax_got[table] == jax_live[table]
    assert port_got[table] == jax_got[table]
    assert port_got[table], f"the sequence left {table} empty"


def test_torn_tail_record_is_ignored(tmp_path):
    """A crash mid-append leaves a torn last record: replay keeps every
    whole record before it, in both packages."""
    from ray_tpu._private.gcs.wal import parse_records as jparse

    from ray_tpu_torch._private.gcs.wal import _LEN, parse_records

    recs = [("kv", "ns", f"k{i}", b"v") for i in range(5)]
    data = b"".join(_LEN.pack(len(b)) + b
                    for b in (pickle.dumps(r) for r in recs))
    torn = data + _LEN.pack(100) + b"\x80\x04partial"
    assert list(parse_records(torn)) == recs == list(jparse(torn))

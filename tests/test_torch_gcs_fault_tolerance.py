"""GCS restart under a live port cluster, held to
``tests/test_gcs_fault_tolerance.py``: durable state survives through
the WAL, nodes register again through the heartbeat's ``ok=false``,
subscribers reconnect, and existing actors and new tasks keep working;
the fourth story recovers a lost head from a ``logd://`` log server
alone. Cases are module-level (``tests/torch_cluster_cases.py``).
"""

import pickle
import time

import pytest

import ray_tpu_torch as rt
import torch_cluster_cases as cases
from ray_tpu_torch._private import messages as pb
from ray_tpu_torch._private import rpc
from ray_tpu_torch.cluster_utils import Cluster

Stateful = rt.remote(cases.Stateful)
double = rt.remote(cases.double)


@pytest.fixture
def persistent_cluster(tmp_path):
    if rt.is_initialized():
        rt.shutdown()
    c = Cluster(head_node_args={"num_cpus": 4},
                gcs_persist_path=str(tmp_path / "gcs_state.bin"))
    yield c
    rt.shutdown()
    c.shutdown()


def _wait_for(fn, timeout_s: float = 30.0, interval_s: float = 0.2):
    deadline = time.monotonic() + timeout_s
    last_exc = None
    while time.monotonic() < deadline:
        try:
            out = fn()
            if out:
                return out
        except Exception as e:  # noqa: BLE001 — retried until the deadline
            last_exc = e
        time.sleep(interval_s)
    if last_exc is not None:
        raise last_exc
    raise AssertionError("condition not met before deadline")


def _wait_alive_nodes(address: str, want: int, timeout_s: float = 15.0):
    gcs = rpc.get_stub("GcsService", address)
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        try:
            alive = [n for n in gcs.GetNodes(pb.GetNodesRequest()).nodes
                     if n.alive]
            if len(alive) >= want:
                return True
        except Exception:  # noqa: BLE001
            pass
        time.sleep(0.1)
    return False


def test_gcs_restart_preserves_cluster(persistent_cluster):
    c = persistent_cluster
    rt.init(address=c.address)
    gcs = rpc.get_stub("GcsService", c.address)
    gcs.KvPut(pb.KvRequest(ns="test", key="k", value=b"v", overwrite=True))
    a = Stateful.options(name="survivor", lifetime="detached").remote()
    assert rt.get(a.inc.remote(), timeout=60) == 1
    assert rt.get(rt.put(123), timeout=60) == 123

    c.restart_gcs()
    assert _wait_alive_nodes(c.address, 1), "node did not re-register"
    reply = _wait_for(lambda: gcs.KvGet(pb.KvRequest(ns="test", key="k")))
    assert reply.found and reply.value == b"v"
    b = _wait_for(lambda: rt.get_actor("survivor"))
    assert rt.get(b.inc.remote(), timeout=60) == 2
    assert rt.get(double.remote(21), timeout=60) == 42


def test_gcs_restart_mid_actor_calls(persistent_cluster):
    c = persistent_cluster
    rt.init(address=c.address)
    a = Stateful.remote()
    assert rt.get(a.inc.remote(), timeout=60) == 1
    c.restart_gcs()
    assert _wait_alive_nodes(c.address, 1)
    assert rt.get(a.inc.remote(), timeout=60) == 2


def test_restored_pending_actor_rescheduled(persistent_cluster):
    """An actor mid-creation (PENDING) when the GCS died is driven through
    the restart path after the snapshot loads."""
    from ray_tpu_torch._private.gcs.server import GcsServer

    c = persistent_cluster
    rt.init(address=c.address)
    a = Stateful.remote()
    assert rt.get(a.inc.remote(), timeout=60) == 1

    port = c.gcs.port
    c.gcs.shutdown()  # writes a final snapshot
    with open(c.gcs_persist_path, "rb") as f:
        state = pickle.loads(f.read())
    infos = {}
    for k, blob in state["actors"].items():
        info = pb.ActorInfo.FromString(blob)
        info.state = "PENDING"
        info.address = ""
        info.node_id = ""
        infos[k] = info
        state["actors"][k] = info.SerializeToString()
    with open(c.gcs_persist_path, "wb") as f:
        f.write(pickle.dumps(state))
    c.gcs = GcsServer(port=port, persist_path=c.gcs_persist_path)

    deadline = time.monotonic() + 60
    gcs = rpc.get_stub("GcsService", c.address)
    aid = next(iter(infos))
    state_seen = ""
    while time.monotonic() < deadline:
        try:
            reply = gcs.GetActor(pb.GetActorRequest(actor_id=aid), timeout=5)
        except rpc.RpcError:
            reply = pb.GetActorReply(found=False)
        if reply.found:
            state_seen = reply.info.state
            if state_seen == "ALIVE":
                break
        time.sleep(0.25)
    assert state_seen == "ALIVE", \
        f"restored PENDING actor stuck in {state_seen!r}"


def test_head_loss_recovers_from_external_wal(tmp_path, monkeypatch):
    """Head-machine loss: with ``RAY_TPU_GCS_WAL_URL`` naming a log server,
    a replacement GCS recovers the cluster from that log alone."""
    from ray_tpu_torch._private.gcs.wal_backend import WalLogServer

    if rt.is_initialized():
        rt.shutdown()
    logd = WalLogServer(str(tmp_path / "walstore"))
    monkeypatch.setenv("RAY_TPU_GCS_WAL_URL", f"logd://{logd.address}")
    monkeypatch.chdir(tmp_path / "walstore")  # catch stray local writes
    c = Cluster(head_node_args={"num_cpus": 4})
    try:
        rt.init(address=c.address)
        gcs = rpc.get_stub("GcsService", c.address)
        gcs.KvPut(pb.KvRequest(ns="ha", key="k", value=b"remote",
                               overwrite=True))
        a = Stateful.options(name="ha_actor", lifetime="detached").remote()
        assert rt.get(a.inc.remote(), timeout=60) == 1
        assert c.gcs.wal_sync(30.0), "WAL appends not durable in time"

        c.restart_gcs()
        assert _wait_alive_nodes(c.address, 1), "node did not re-register"

        def _kv_restored():
            r = gcs.KvGet(pb.KvRequest(ns="ha", key="k"))
            return r if r.found else None

        assert _wait_for(_kv_restored).value == b"remote"
        b = _wait_for(lambda: rt.get_actor("ha_actor"))
        assert rt.get(b.inc.remote(), timeout=60) == 2
        assert rt.get(double.remote(21), timeout=60) == 42
        assert not any(p.name.startswith("gcs_state")
                       for p in (tmp_path / "walstore").iterdir()
                       if p.is_file())
    finally:
        rt.shutdown()
        c.shutdown()
        logd.close()

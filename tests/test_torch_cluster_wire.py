"""The cluster runtime's wire (``ray_tpu_torch/_private/rpc.py``) and
object serialization (``_private/serialization.py``), whose rules are
the port's own (ROADMAP.md §C): frames split at every byte boundary and
interleaved request ids reach their callers; a closure or a lambda
raises the ``TypeError`` that names the module-level rule; a CUDA tensor
reaches a receiver as a host tensor; a card a cluster node owns is out
of the process's card book, so a serve replica cannot take it.
"""

import pickle
import socket
import struct
import threading
import time

import numpy as np
import pytest
import torch

import ray_tpu_torch as rt
from ray_tpu_torch._private import messages as pb
from ray_tpu_torch._private import rpc
from ray_tpu_torch._private import serialization as ser

_HDR = struct.Struct("<IBI")


class _Echo:
    """A ``GcsService`` whose ``KvGet`` echoes the key after a delay the
    key names (so replies come back out of order)."""

    def KvGet(self, request, context):
        time.sleep(float(request.key.split(":")[1]))
        return pb.KvReply(found=True, value=request.key.encode())


@pytest.fixture
def echo_server():
    server, port = rpc.serve("GcsService", _Echo())
    yield f"127.0.0.1:{port}"
    server.stop()
    rpc.drop_connection(f"127.0.0.1:{port}")


def _frame(req_id, method, request):
    payload = rpc._call_payload(method, request)
    return _HDR.pack(req_id, rpc.KIND_CALL, len(payload)) + payload


def _read_frame(sock):
    hdr = rpc._recv_exact(sock, _HDR.size)
    req_id, kind, n = _HDR.unpack(hdr)
    return req_id, kind, rpc._recv_exact(sock, n)


def test_server_reads_frames_split_at_every_byte(echo_server):
    host, port = echo_server.split(":")
    with socket.create_connection((host, int(port))) as sock:
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        a = _frame(7, "KvGet", pb.KvRequest(key="a:0.2"))
        b = _frame(9, "KvGet", pb.KvRequest(key="b:0"))
        # Both frames one byte per send; the slow one (7) answers last.
        for x in a + b:
            sock.sendall(bytes([x]))
        got = dict((req_id, pickle.loads(body).value)
                   for req_id, kind, body in (_read_frame(sock),
                                              _read_frame(sock)))
    assert got == {7: b"a:0.2", 9: b"b:0"}


def test_client_reads_replies_split_at_every_byte_out_of_order():
    """A server that answers in reverse order, one byte per send: each
    caller still gets its own reply."""
    listener = socket.socket()
    listener.bind(("127.0.0.1", 0))
    listener.listen(1)
    port = listener.getsockname()[1]

    def serve():
        conn, _ = listener.accept()
        frames = []
        for _ in range(3):
            req_id, kind, body = _read_frame(conn)
            frames.append((req_id, body))
        for req_id, body in reversed(frames):
            method_len = struct.unpack_from("<H", body)[0]
            request = pickle.loads(body[2 + method_len:])
            reply = pickle.dumps(pb.KvReply(value=request.key.encode()))
            out = _HDR.pack(req_id, rpc.KIND_CALL | rpc.KIND_REPLY_BIT,
                            len(reply)) + reply
            for x in out:
                conn.sendall(bytes([x]))
        conn.close()

    t = threading.Thread(target=serve)
    t.start()
    conn = rpc.Connection(f"127.0.0.1:{port}")
    futs = [conn.call_future(rpc.KIND_CALL, rpc._call_payload(
        "KvGet", pb.KvRequest(key=f"k{i}"))) for i in range(3)]
    got = [pickle.loads(conn.result(f, 10)).value for f in futs]
    assert got == [b"k0", b"k1", b"k2"]
    t.join(10)
    conn.close()
    listener.close()


def test_concurrent_callers_share_one_connection(echo_server):
    stub = rpc.get_stub("GcsService", echo_server)
    delays = [0.3, 0.0, 0.2, 0.1, 0.05, 0.25]
    out = [None] * len(delays)

    def call(i):
        out[i] = stub.KvGet(pb.KvRequest(key=f"{i}:{delays[i]}")).value

    threads = [threading.Thread(target=call, args=(i,))
               for i in range(len(delays))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(10)
    assert out == [f"{i}:{d}".encode() for i, d in enumerate(delays)]
    conn = rpc.get_connection(echo_server)
    assert len([c for c in rpc._conns.values() if c is conn]) == 1


def test_handler_error_and_dead_server_raise_rpc_errors(echo_server):
    stub = rpc.get_stub("GcsService", echo_server)
    with pytest.raises(rpc.RpcError) as e:
        stub.KvGet(pb.KvRequest(key="no-delay"))  # float("") raises
    assert e.value.code() == rpc.StatusCode.INTERNAL
    with pytest.raises(rpc.RpcError) as e:
        rpc.get_stub("GcsService", "127.0.0.1:1").KvGet(pb.KvRequest())
    assert e.value.code() == rpc.StatusCode.UNAVAILABLE


def test_closure_and_lambda_raise_the_module_level_rule():
    def closure():
        return 1

    for fn in (closure, lambda: 2):
        with pytest.raises(TypeError, match="must be defined at module "
                                            "level"):
            ser.dumps((fn, (), {}))
    # A module-level function behind its @remote wrapper crosses.
    wrapped = ser.loads(ser.dumps(rt.remote(np.add)._function))
    assert wrapped is np.add


class _OnCard(torch.Tensor):
    """A host tensor that reports a card: what a CUDA tensor looks like to
    the serializer on a box without one."""

    @property
    def device(self):
        return torch.device("cuda", 3)


def test_cuda_tensor_crosses_as_a_host_tensor():
    t = torch.arange(6, dtype=torch.float32).as_subclass(_OnCard)
    got = ser.loads(ser.dumps({"w": t}))["w"]
    assert type(got) is torch.Tensor and got.device.type == "cpu"
    assert torch.equal(got, torch.arange(6, dtype=torch.float32))


@pytest.mark.gpu
def test_real_cuda_tensor_crosses_as_a_host_tensor():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    t = torch.arange(6, device="cuda", dtype=torch.float32)
    got = ser.loads(ser.dumps(t))
    assert got.device.type == "cpu" and torch.equal(got, t.cpu())


def test_a_cluster_node_holds_its_cards_in_the_card_book(monkeypatch):
    """On one card, a cluster node that owns it and a
    ``serve.run(..., num_gpus=1)`` replica in the same process do not both
    get it; the node's shutdown gives it back."""
    from ray_tpu_torch.cluster_utils import Cluster
    from ray_tpu_torch.runtime import controller

    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "0")
    c = Cluster(head_node_args={"num_cpus": 1, "num_gpus": 1})
    try:
        assert controller.CARDS.use().get("0") == 1.0
        assert controller.CARDS.take(1) is None      # a replica's ask
        assert controller.CARDS.free_cards() == 0
        with pytest.raises(RuntimeError, match="in use"):
            c.add_node(num_cpus=1, num_gpus=1)       # same card again
    finally:
        c.shutdown()
    assert controller.CARDS.free_cards() == 1
    got = controller.CARDS.take(1)
    assert got == [["0"]]
    controller.CARDS.give(["0"], 1.0)
    # And the other way round: a card a replica holds cannot make a node.
    got = controller.CARDS.take(1)
    try:
        with pytest.raises(RuntimeError, match="in use"):
            Cluster(head_node_args={"num_cpus": 1, "num_gpus": 1})
    finally:
        controller.CARDS.give(["0"], 1.0)


def test_start_cluster_env_and_auto_address(monkeypatch, tmp_path):
    """``RAY_TPU_START_CLUSTER=1`` makes ``init()`` start a local cluster
    and connect to it, and ``shutdown()`` stops it; ``address="auto"``
    finds a running cluster through the port's address file."""
    import torch_cluster_cases as cases
    from ray_tpu_torch._private import worker as worker_mod
    from ray_tpu_torch.cluster_utils import Cluster

    if rt.is_initialized():
        rt.shutdown()
    monkeypatch.setenv("RAY_TPU_START_CLUSTER", "1")
    rt.init(num_cpus=2, num_gpus=0)
    try:
        started = worker_mod.global_worker().core.started_cluster
        assert worker_mod.global_worker().mode == "driver"
        assert rt.cluster_resources()["CPU"] == 2.0
        assert rt.get(rt.remote(cases.add).remote(2, 3), timeout=60) == 5
    finally:
        rt.shutdown()
    assert started.gcs._stop.is_set() and not started.nodes
    monkeypatch.delenv("RAY_TPU_START_CLUSTER")

    c = Cluster(head_node_args={"num_cpus": 1})
    try:
        monkeypatch.setattr(worker_mod, "ADDRESS_FILE",
                            str(tmp_path / "addr"))
        (tmp_path / "addr").write_text(c.address + "\n")
        rt.init(address="auto")
        assert rt.get(rt.remote(cases.add).remote(1, 1), timeout=60) == 2
    finally:
        rt.shutdown()
        c.shutdown()

"""The trainer's and RLlib's worker groups on the port's cluster runtime
(fault C9), held to JAX's: each ``TrainWorker`` is an actor of the
runtime (``ray_tpu/train/backend_executor.py:249-265``: ``num_cpus``, the
worker's other resources, ``max_concurrency=3``), and the trainer reads
the runtime's ``available_resources()`` (``ray_tpu/train/trainer.py:158``).

After ``init(address=...)`` on a CPU ``cluster_utils.Cluster``: a
``TorchTrainer(use_gpu=False)`` run's workers report a cluster node's id
and charge its CPUs while they run, the actors asking for what JAX's
``WorkerGroup`` asks (``num_cpus``, ``resources``, ``max_concurrency``;
JAX's local runtime does not charge actors, so the comparison is of the
options); ``_available`` reads the cluster's resources; a
``use_gpu`` trainer after a node that owns card 0 runs its worker on that
node with ``CUDA_VISIBLE_DEVICES=0`` and books nothing in this process's
card book (the forked path waited 600 s on that book); a learner group
and two env runners land as cluster actors; and nothing the groups
started outlives their shutdown. The train loops are module-level in
``tests/torch_train_loops.py``, the learner and the runner class in
``tests/torch_rl_helpers.py`` and ``tests/torch_rllib_helpers.py``. The
``gpu``-marked twin runs a loop on a real card. Every test is bounded by
an alarm of its own.
"""

import signal
import threading
import time

import pytest

import ray_tpu
import ray_tpu_torch as rt
import torch_rl_helpers as rlh
import torch_rllib_helpers as h
import torch_train_loops as loops
from ray_tpu_torch import train as tt
from ray_tpu_torch.cluster_utils import Cluster
from ray_tpu_torch.runtime.cluster_replica import ClusterReplica
from ray_tpu_torch.runtime.controller import CARDS
from ray_tpu_torch.train import trainer as trainer_mod

LIMIT_S = 90


@pytest.fixture(autouse=True)
def _bounded():
    def expire(*_):
        raise TimeoutError(f"test ran past its {LIMIT_S} s")

    old = signal.signal(signal.SIGALRM, expire)
    signal.alarm(LIMIT_S)
    yield
    signal.alarm(0)
    signal.signal(signal.SIGALRM, old)


@pytest.fixture
def cpu_cluster():
    for pkg in (ray_tpu, rt):
        if pkg.is_initialized():
            pkg.shutdown()
    c = Cluster(head_node_args={"num_cpus": 4})
    c.wait_for_nodes()
    rt.init(address=c.address)
    yield c
    rt.shutdown()
    c.shutdown()


def _gone(cluster, pids, timeout_s=20.0) -> bool:
    """True once no node of ``cluster`` has a live worker of ``pids``."""
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if not set(pids) & {p for n in cluster.nodes
                            for p in n.worker_pids()}:
            return True
        time.sleep(0.1)
    return False


def _watch_cpu(stop, seen, pkg=rt):
    while not stop.is_set():
        seen.append(pkg.available_resources().get("CPU", 0.0))
        time.sleep(0.05)


def test_trainer_workers_are_cluster_actors_that_charge_cpus(cpu_cluster,
                                                              tmp_path):
    c = cpu_cluster
    assert trainer_mod._available() == {"CPU": 4.0, "GPU": 0.0}
    seen, stop = [], threading.Event()
    watcher = threading.Thread(target=_watch_cpu, args=(stop, seen))
    watcher.start()
    try:
        trainer = tt.TorchTrainer(
            loops.where_loop, train_loop_config={"steps": 3, "hold_s": 0.4},
            scaling_config=tt.ScalingConfig(num_workers=2, use_gpu=False),
            run_config=tt.RunConfig(storage_path=str(tmp_path)))
        result = trainer.fit()
    finally:
        stop.set()
        watcher.join()
    assert result.error is None, result.error
    recs = [m["metrics"] for m in result.metrics_history]
    assert 0 in {r["rank"] for r in recs}
    assert {r["node_id"] for r in recs} == {c.head_node.node_id}
    assert {r["cuda_visible_devices"] for r in recs} == {""}
    # Two workers of one CPU each charged the head's 4 and gave them
    # back.
    assert min(seen) == 2.0
    assert _gone(c, {r["pid"] for r in recs})
    deadline = time.monotonic() + 10
    while rt.available_resources()["CPU"] != 4.0 and \
            time.monotonic() < deadline:
        time.sleep(0.05)
    assert rt.available_resources()["CPU"] == 4.0


def test_worker_actor_options_match_jax(cpu_cluster):
    from ray_tpu.train import ScalingConfig as JScaling
    from ray_tpu.train.backend_executor import WorkerGroup as JGroup
    from ray_tpu_torch.train import backend_executor as bexec

    scaling = dict(num_workers=1, cpus_per_worker=2.0,
                   resources_per_worker={"extra": 0.5})
    cpu_cluster.add_node(num_cpus=2, resources={"extra": 1.0})
    cpu_cluster.wait_for_nodes()
    group = bexec.WorkerGroup(tt.ScalingConfig(use_gpu=False, **scaling))
    try:
        got = group.workers[0].actor._options
    finally:
        group.shutdown()
    ray_tpu.init(num_cpus=4, num_tpus=0, resources={"extra": 1.0})
    try:
        want = JGroup(JScaling(**scaling)).workers[0]._options
    finally:
        ray_tpu.shutdown()
    for key in ("num_cpus", "resources", "max_concurrency"):
        assert getattr(got, key) == getattr(want, key), key
    assert not got.num_gpus


def test_available_reads_the_cluster(cpu_cluster):
    c = cpu_cluster
    c.add_node(num_cpus=2, resources={"extra": 3.0})
    c.wait_for_nodes()
    deadline = time.monotonic() + 10
    while trainer_mod._available().get("CPU") != 6.0 and \
            time.monotonic() < deadline:
        time.sleep(0.05)
    avail = trainer_mod._available()
    assert avail["CPU"] == 6.0 and avail["GPU"] == 0.0
    assert avail["extra"] == 3.0
    assert avail == {"GPU": 0.0, **rt.available_resources()}


def test_use_gpu_trainer_after_a_card_node_books_no_card(cpu_cluster,
                                                         tmp_path,
                                                         monkeypatch):
    """The node owns card 0 (out of this process's card book): the
    worker is placed there, sees card 0, and the book does not move; a
    worker start that could not book a card used to wait 600 s here."""
    from ray_tpu_torch.train import backend_executor as bexec

    c = cpu_cluster
    card = c.add_node(num_cpus=2, num_gpus=1, card_ids=[0])
    c.wait_for_nodes()
    book = CARDS.use()
    monkeypatch.setattr(bexec, "WORKER_START_S", 60.0)
    trainer = tt.TorchTrainer(
        loops.where_loop, train_loop_config={"steps": 2, "hold_s": 0.2},
        scaling_config=tt.ScalingConfig(num_workers=1, use_gpu=True),
        run_config=tt.RunConfig(storage_path=str(tmp_path)))
    t0 = time.monotonic()
    result = trainer.fit()
    assert time.monotonic() - t0 < 45
    assert result.error is None, result.error
    recs = [m["metrics"] for m in result.metrics_history]
    assert {r["node_id"] for r in recs} == {card.node_id}
    assert {r["cuda_visible_devices"] for r in recs} == {"0"}
    assert CARDS.use() == book
    assert _gone(c, {r["pid"] for r in recs})


def test_infeasible_gpu_group_raises_without_waiting(cpu_cluster,
                                                     monkeypatch):
    """No node has a card: the group's start raises the runtime's own
    error at once instead of waiting its start timeout."""
    from ray_tpu_torch.train import backend_executor as bexec

    monkeypatch.setattr(bexec, "WORKER_START_S", 600.0)
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="failed to start"):
        bexec.WorkerGroup(tt.ScalingConfig(num_workers=1, use_gpu=True))
    assert time.monotonic() - t0 < 30


def test_learner_group_and_env_runners_are_cluster_actors(cpu_cluster):
    from ray_tpu_torch.rllib import LearnerGroup
    from ray_tpu_torch.rllib import env_runner as er

    c = cpu_cluster
    group = LearnerGroup(rlh.ToyLearner, num_learners=1, use_gpu=False)
    runners = [er.start_runner(h.Member, i) for i in range(2)]
    try:
        assert all(isinstance(m, ClusterReplica)
                   for m in group.learners + runners)
        w = group.get_weights()
        assert list(w["w"]) == [1.0, 1.0, 1.0, 1.0]
        er.wait_started(runners)
        got = er.call_all(runners, "value", 5)
        assert [g[:2] for g in got] == [(0, 5), (1, 5)]
        pids = {g[2] for g in got} | {m.pid for m in group.learners}
        assert len(pids) == 3
        assert pids <= {p for n in c.nodes for p in n.worker_pids()}
        # One CPU each: two runners and a CPU learner.
        deadline = time.monotonic() + 10
        while rt.available_resources()["CPU"] != 1.0 and \
                time.monotonic() < deadline:
            time.sleep(0.05)
        assert rt.available_resources()["CPU"] == 1.0
    finally:
        group.shutdown()
        for r in runners:
            r.kill()
    assert _gone(c, pids)


@pytest.mark.gpu
def test_use_gpu_trainer_runs_on_the_card_node_of_a_cluster(tmp_path):
    """On a card: the worker a ``use_gpu`` trainer starts on a cluster
    computes on the card node's card, and the card book does not move."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the worker computes on the card")
    for pkg in (ray_tpu, rt):
        if pkg.is_initialized():
            pkg.shutdown()
    c = Cluster(head_node_args={"num_cpus": 2})
    card = c.add_node(num_cpus=2, num_gpus=1, card_ids=[0])
    c.wait_for_nodes()
    rt.init(address=c.address)
    try:
        book = CARDS.use()
        result = tt.TorchTrainer(
            loops.card_loop, train_loop_config={},
            scaling_config=tt.ScalingConfig(num_workers=1, use_gpu=True),
            run_config=tt.RunConfig(storage_path=str(tmp_path))).fit()
        assert result.error is None, result.error
        (rec,) = [m["metrics"] for m in result.metrics_history]
        assert rec["sum"] == 28.0 and rec["cuda_visible_devices"] == "0"
        assert rec["pid"] in card.worker_pids() or _gone(c, {rec["pid"]})
        assert CARDS.use() == book
    finally:
        rt.shutdown()
        c.shutdown()

"""The port's ``LearnerGroup`` (``ray_tpu_torch/rllib/learner_group.py``)
on CPU learner processes: two gloo learners stay bit-identical over
updates; their update equals one learner's over the whole batch, and JAX's
``LearnerGroup`` actors' on the same shards, within fp32 tolerance
(learners with a plain gradient step: Adam's step turns a grad near its
eps into a visible difference); the ``perturb_learner`` chaos action trips the group's
bit-identity check and emits ``rl.learner_divergence`` (the case of
``tests/test_rl_loop.py``'s
``test_learner_group_bit_identity_check_catches_perturbation``). The
learners fork from the runtime's fork server and import their builders
from ``tests/torch_rl_helpers.py`` (no JAX)."""

import numpy as np
import pytest
import torch

import torch_rl_helpers as h
from ray_tpu_torch._private import chaos
from ray_tpu_torch._private import events as flight
from ray_tpu_torch.rl import ExperienceBuffer, SequenceRecord
from ray_tpu_torch.rl.weight_sync import _flat
from ray_tpu_torch.rllib import LearnerGroup


@pytest.fixture(autouse=True)
def _chaos_clean():
    yield
    chaos.configure(None)


def _batch(seed, n=4, t=4):
    """n sequences of t tokens each (so each learner's shard normalizes
    its loss by the same token count)."""
    rng = np.random.default_rng(seed)
    buf = ExperienceBuffer()
    for i in range(n):
        buf.add(SequenceRecord(
            prompt=[int(x) for x in rng.integers(1, 200, size=2 + i % 2)],
            tokens=[int(x) for x in rng.integers(1, 200, size=t)],
            logprobs=(-rng.uniform(4.0, 6.0, size=t)).astype(np.float32),
            reward=float(rng.uniform()), weight_version=0, staleness=0))
    return buf.to_batch()


def _same_bits(a, b):
    return all(torch.equal(x.view(torch.uint8), y.view(torch.uint8))
               for (_, x), (_, y) in zip(_flat(a), _flat(b)))


@pytest.fixture
def groups():
    two = LearnerGroup(h.build_tiny_learner, num_learners=2, use_gpu=False)
    yield two
    two.shutdown()


def test_two_learners_stay_bit_identical_over_updates(groups, monkeypatch):
    two = groups
    monkeypatch.setenv("RAY_TPU_RL_DEBUG", "1")    # verified reads
    assert _same_bits(*two.get_all_weights())
    for seed in range(3):
        metrics = two.update(_batch(seed))
        assert np.isfinite(metrics["total_loss"])
        w0, w1 = two.get_all_weights()
        assert _same_bits(w0, w1), f"learners diverged at update {seed}"
        two.get_weights()                # the group's own check passes


def test_two_learners_update_as_one_over_the_whole_batch():
    """The allreduce average of the two halves' grads is the whole
    batch's grad: the same step as one learner's, within fp32."""
    two = LearnerGroup(h.build_sgd_learner, num_learners=2, use_gpu=False)
    one = LearnerGroup(h.build_sgd_learner, num_learners=1, use_gpu=False)
    try:
        assert _same_bits(two.get_weights(), one.get_weights())
        for seed in range(2):
            batch = _batch(seed)
            m2, m1 = two.update(batch), one.update(batch)
            assert np.isfinite(m2["total_loss"])
            for (_, a), (_, b) in zip(_flat(two.get_weights()),
                                      _flat(one.get_weights())):
                np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5,
                                           atol=1e-6)
    finally:
        two.shutdown()
        one.shutdown()


class _Remote:
    def __init__(self, fn):
        self.remote = fn


class _Store:
    """JAX's ``_RendezvousStore`` behind ``.remote`` methods, for JAX
    learner actors that are threads of this process."""

    def __init__(self, n):
        import threading

        from ray_tpu.util.collective import collective as jcoll

        self._s, self._lock = jcoll._RendezvousStore(n), threading.Lock()
        self.put = _Remote(self._locked(self._s.put))
        self.collect = _Remote(self._locked(self._s.collect))

    def _locked(self, fn):
        def call(*args):
            with self._lock:
                return fn(*args)
        return call


def test_two_learners_update_as_jax_learner_group(monkeypatch):
    """The port's two-learner update against JAX's ``LearnerGroup``
    arithmetic on the same shards: JAX's ``_LearnerActor.update`` in two
    threads over JAX's host collective group, each actor holding JAX's
    PPO learner from the same params under the same plain gradient step
    (``build_sgd_learner``'s); the weights agree within rtol 1e-5 / atol
    1e-6."""
    import threading

    import jax
    import jax.numpy as jnp

    import ray_tpu
    from ray_tpu.models import llama as jl
    from ray_tpu.rl import experience as jexp
    from ray_tpu.rllib import learner_group as jlg
    from ray_tpu.util.collective import collective as jcoll
    from ray_tpu_torch.interop import params_to_numpy

    batch = _batch(1)
    two = LearnerGroup(h.build_sgd_learner, num_learners=2, use_gpu=False)
    try:
        start = two.get_weights()
        two.update(batch)
        got = two.get_weights()
    finally:
        two.shutdown()
    assert not _same_bits(start, got)            # the update moved them

    class JaxSGD(jexp.TokenPPOLearner):
        def apply_gradients(self, grads):
            self.params = jax.tree.map(lambda p, g: p - 1e-2 * g,
                                       self.params, grads)

    monkeypatch.setattr(ray_tpu, "get", lambda x, **kw: x)
    store = _Store(2)
    actors = []
    for rank in range(2):
        actor = object.__new__(jlg._LearnerActor)
        actor.learner = JaxSGD(
            jl.LlamaConfig.tiny(dtype=jnp.float32),
            params=jax.tree.map(jnp.asarray, params_to_numpy(start)))
        actor.rank, actor.world_size = rank, 2
        actor.group = jcoll.CollectiveGroup("j", 2, rank, store)
        actors.append(actor)
    errors = []

    def run(actor, shard):
        try:
            with jax.default_matmul_precision("highest"):
                actor.update(shard)
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append(e)

    threads = [threading.Thread(target=run, args=(a, s)) for a, s in
               zip(actors, jlg.LearnerGroup._shard(batch, 2))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(120)
    assert not errors, errors
    want = actors[0].learner.get_weights()
    pairs = list(zip(_flat(got), _flat(want)))
    assert pairs and all(pa == pb for (pa, _), (pb, _) in pairs)
    for (_, a), (_, b) in pairs:
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-5, atol=1e-6)


def test_update_many_keeps_the_rounds_aligned(groups):
    two = groups
    two.update_many([_batch(5), _batch(6)])
    assert _same_bits(*two.get_all_weights())


def test_perturb_learner_trips_the_divergence_check():
    group = LearnerGroup(h.ToyLearner, num_learners=2, use_gpu=False)
    try:
        # Chaos plan armed but firing 0 times: the verified read agrees.
        chaos.configure("perturb_learner:rank=1,eps=0.5,times=0")
        w = group.get_weights()
        assert np.array_equal(w["w"], np.ones(4, np.float32))
        # Now the fault: rank 1 reports perturbed weights exactly once.
        chaos.configure("perturb_learner:rank=1,eps=0.5")
        with pytest.raises(RuntimeError, match="diverged"):
            group.get_weights()
        fired = [e for e in chaos.injection_log()
                 if e["action"] == "perturb_learner"]
        assert fired and fired[-1]["coords"]["rank"] == 1
        divs = flight.local_events(types=["rl.learner_divergence"])
        assert divs and divs[-1]["attrs"]["rank"] == 1
        # The fault was in the REPORT, not the replica: with the rule
        # spent, the verified read converges again.
        w2 = group.get_weights()
        assert np.array_equal(w2["w"], np.ones(4, np.float32))
    finally:
        group.shutdown()

"""The port's RL post-training pieces (``ray_tpu_torch/rl``) against the
JAX package's ``ray_tpu/rl``: the analogs of ``tests/test_rl_loop.py``'s
unit and engine cases.

- manifests of the same converted params equal JAX's, crc for crc (bf16
  leaves carry their 16 bits; the port keeps no ``ml_dtypes``), and the
  crc gate refuses a corrupted payload;
- the fast path lands a publish crc-verified and on disk as the slow
  path's checkpoint; a stalled subscriber is shed by name; the ``__rl__``
  mirror answers through a dict or a store;
- ``to_batch`` and ``LearnerGroup._shard`` equal JAX's, array for array;
- ``TokenPPOLearner``'s loss, metrics and grads on the tiny fp32 config
  equal JAX's within rtol 1e-5 / atol 1e-6, and so do the params after
  one Adam step;
- the rollout scheduler's staleness clip and metrics;
- a swap mid-request lands at a tick boundary; fast == slow bit for bit;
- the deployment's weight sync takes the fast path and, the channel
  closed, the slow path;
- the entry points default to the card.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import llama as jl
from ray_tpu.rl import experience as jexp
from ray_tpu.rl import weight_sync as jws
from ray_tpu_torch._private import events as flight
from ray_tpu_torch._private import metrics_defs as mdefs
from ray_tpu_torch.checkpoint import CheckpointPlane, load_latest
from ray_tpu_torch.interop import params_from_numpy, params_to_numpy
from ray_tpu_torch.models import llama as tl
from ray_tpu_torch.models.continuous_batching import ContinuousBatcher
from ray_tpu_torch.rl import (ExperienceBuffer, RolloutScheduler,
                              SequenceRecord, TokenPPOLearner,
                              WeightPublisher, WeightSubscriber,
                              WeightSyncError, build_manifest,
                              latest_manifest, verify_manifest)
from ray_tpu_torch.rl.weight_sync import _host_leaves

TCFG = tl.LlamaConfig.tiny(dtype=torch.float32)
JCFG = jl.LlamaConfig.tiny(dtype=jnp.float32)


def _tparams(seed=0, dtype=torch.float32, scale=1.0):
    cfg = tl.LlamaConfig.tiny(dtype=dtype)
    p = tl.init_params(cfg, torch.Generator().manual_seed(seed), "cpu")
    if scale != 1.0:
        p = {k: ({kk: (vv * scale).to(vv.dtype) for kk, vv in v.items()}
                 if isinstance(v, dict) else (v * scale).to(v.dtype))
             for k, v in p.items()}
    return p


def _jparams(tparams):
    return jax.tree.map(jnp.asarray, params_to_numpy(
        tparams, bf16_dtype=jnp.dtype(jnp.bfloat16)))


def _assert_tree_equal(a, b):
    la, lb = _host_leaves(a), _host_leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert torch.equal(x.view(torch.uint8) if x.dtype == torch.bfloat16
                           else x, y.view(torch.uint8)
                           if y.dtype == torch.bfloat16 else y)


def _counter_value(metric, **want):
    total = 0.0
    for _, tags, v in metric.samples():
        td = dict(tags)
        if all(td.get(k) == v2 for k, v2 in want.items()):
            total += v
    return total


# -------------------------------------------------------- manifests
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
def test_manifest_equals_jax_apart_from_ts(dtype):
    tp = _tparams(dtype=dtype)
    jp = _jparams(tp)
    jm = jws.build_manifest("r", 3, 7, [np.asarray(x)
                                        for x in jax.tree.leaves(jp)],
                            ckpt_root="/c", ckpt_run="run")
    tm = build_manifest("r", 3, 7, _host_leaves(tp), ckpt_root="/c",
                        ckpt_run="run")
    jm.pop("ts"), tm.pop("ts")
    assert tm == jm
    assert {leaf["dtype"] for leaf in tm["leaves"]} >= {
        "bfloat16" if dtype == torch.bfloat16 else "float32"}


def test_manifest_roundtrip_and_crc_gate():
    leaves = _host_leaves(_tparams())
    manifest = build_manifest("r", version=3, step=7, leaves=leaves)
    assert manifest["version"] == 3 and manifest["step"] == 7
    assert manifest["bytes"] == sum(a.numel() * a.element_size()
                                    for a in leaves)
    verify_manifest(manifest, leaves)
    corrupted = [a.clone() for a in leaves]
    corrupted[0].view(-1)[0] += 1
    with pytest.raises(WeightSyncError, match="crc mismatch"):
        verify_manifest(manifest, corrupted)
    with pytest.raises(WeightSyncError, match="leaves"):
        verify_manifest(manifest, leaves[:-1])
    # A JAX manifest gates the port's leaves of the same params.
    jm = jws.build_manifest("r", 3, 7, [np.asarray(x) for x in
                                        jax.tree.leaves(_jparams(
                                            _tparams()))])
    verify_manifest(jm, leaves)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
def test_publisher_subscriber_fast_path(tmp_path, dtype):
    """One publish lands in the subscriber crc-verified AND on disk as a
    committed checkpoint at step=version (the slow path's source)."""
    plane = CheckpointPlane(str(tmp_path), run="rlsync",
                            process_index=0, process_count=1)
    pub = WeightPublisher(run="rlsync", n_subscribers=1, ckpt_plane=plane)
    try:
        sub = WeightSubscriber(pub.subscriber_spec(0), run="rlsync")
        assert sub.poll(timeout=0.05) is None   # nothing published yet
        params = _tparams(dtype=dtype)
        before = _counter_value(mdefs.RL_SYNC_BYTES, run="rlsync",
                                path="publish")
        manifest = pub.publish(params, step=12)
        assert manifest["version"] == 1 and "shed" not in manifest
        assert set(pub.last_timing) == {"host_s", "save_s", "write_s"}
        got = sub.poll(timeout=5.0)
        assert got is not None
        m, received = got
        assert m["version"] == 1 and sub.version == 1
        _assert_tree_equal(params, received)
        cold = load_latest(str(tmp_path), run="rlsync", step=1)
        _assert_tree_equal(params, getattr(cold, "params", cold))
        assert _counter_value(mdefs.RL_SYNC_BYTES, run="rlsync",
                              path="publish") == before + manifest["bytes"]
    finally:
        pub.destroy()
        plane.close()


def test_publish_shed_names_the_lagging_subscriber():
    pub = WeightPublisher(run="shed", n_subscribers=2,
                          publish_timeout_s=0.2)
    try:
        fast = WeightSubscriber(pub.subscriber_spec(0), run="shed")
        params = _tparams()
        before = _counter_value(mdefs.RL_SYNC_SHED, run="shed")
        m1 = pub.publish(params, step=0)   # lands (nothing to ack yet)
        assert "shed" not in m1
        assert fast.poll(timeout=5.0) is not None   # reader 0 keeps up
        m2 = pub.publish(params, step=1)   # reader 1 never read v1
        assert m2["shed"] == [1], "shed must name subscriber 1"
        assert pub.lagging_subscribers() == [1]
        assert _counter_value(mdefs.RL_SYNC_SHED, run="shed",
                              subscriber="1") == before + 1
        sheds = flight.local_events(types=["rl.publish_shed"])
        assert any(e["subject"].get("run") == "shed" for e in sheds)
    finally:
        pub.destroy()


@pytest.mark.parametrize("kind", ["dict", "store", "none"])
def test_manifest_mirror_and_fallback_through_the_kv(tmp_path, kind):
    import datetime

    import torch.distributed as dist

    kv = {"dict": {}, "none": None,
          "store": dist.TCPStore("127.0.0.1", 0, 1, True,
                                 timeout=datetime.timedelta(seconds=10))}[kind]
    plane = CheckpointPlane(str(tmp_path), run="mirror",
                            process_index=0, process_count=1)
    pub = WeightPublisher(run="mirror", ckpt_plane=plane, kv=kv,
                          publish_timeout_s=0.1)
    try:
        params = _tparams(seed=4)
        m = pub.publish(params, step=5)
        latest = latest_manifest("mirror", kv)
        sub = WeightSubscriber(None, run="mirror", kv=kv)
        if kind == "none":
            assert latest is None
            with pytest.raises(WeightSyncError, match="no checkpoint"):
                sub.restore_fallback()
            return
        assert latest["version"] == m["version"] == 1
        assert latest["leaves"] == m["leaves"]
        manifest, restored = sub.restore_fallback()
        assert manifest["version"] == 1 and sub.version == 1
        _assert_tree_equal(params, restored)
    finally:
        pub.destroy()
        plane.close()


# ------------------------------------------------- experience + PPO
def _records(mod):
    return [
        mod.SequenceRecord(prompt=[1, 2, 3], tokens=[7, 8],
                           logprobs=np.array([-1.0, -2.0], np.float32),
                           reward=1.0, weight_version=2, staleness=0),
        mod.SequenceRecord(prompt=[4, 5], tokens=[9, 10, 11],
                           logprobs=np.array([-0.5, -0.25, -3.0],
                                             np.float32),
                           reward=0.0, weight_version=1, staleness=1),
        mod.SequenceRecord(prompt=[6], tokens=[12, 13, 14],
                           logprobs=np.array([-4.0, -1.5, -0.75],
                                             np.float32),
                           reward=0.5, weight_version=1, staleness=2),
    ]


@pytest.mark.parametrize("max_len", [None, 12])
def test_to_batch_equals_jax_array_for_array(max_len):
    jb, tb = jexp.ExperienceBuffer(), ExperienceBuffer()
    for jr, tr in zip(_records(jexp), _records(__import__(
            "ray_tpu_torch.rl.experience", fromlist=["x"]))):
        jb.add(jr)
        tb.add(tr)
    jbatch, tbatch = jb.to_batch(max_len), tb.to_batch(max_len)
    assert list(tbatch) == list(jbatch)
    for k in jbatch:
        assert tbatch[k].dtype == jbatch[k].dtype, k
        np.testing.assert_array_equal(tbatch[k], jbatch[k])
    assert tb.staleness() == jb.staleness() == [0, 1, 2]


def test_learner_group_shard_equals_jax():
    from ray_tpu.rllib.learner_group import LearnerGroup as JLG
    from ray_tpu_torch.rllib.learner_group import LearnerGroup as TLG

    buf = ExperienceBuffer()
    for r in _records(__import__("ray_tpu_torch.rl.experience",
                                 fromlist=["x"])):
        buf.add(r)
    batch = buf.to_batch()
    for n in (1, 2, 3, 4):
        js, ts = JLG._shard(batch, n), TLG._shard(batch, n)
        assert len(js) == len(ts) == n
        for a, b in zip(js, ts):
            for k in a:
                np.testing.assert_array_equal(a[k], b[k])


def _ppo_batch(seed=0, n=4, t=5):
    rng = np.random.default_rng(seed)
    buf = ExperienceBuffer()
    for i in range(n):
        plen = 2 + i % 3
        buf.add(SequenceRecord(
            prompt=[int(x) for x in rng.integers(1, 200, size=plen)],
            tokens=[int(x) for x in rng.integers(1, 200, size=t)],
            logprobs=(-rng.uniform(3.0, 7.0, size=t)).astype(np.float32),
            reward=float(rng.uniform()), weight_version=0,
            staleness=int(i % 2)))
    return buf.to_batch()


def _jleaves(tree):
    return [np.asarray(x) for x in jax.tree.leaves(tree)]


@pytest.mark.parametrize("rho_clip,entropy", [(None, 0.0), (2.0, 0.01)],
                         ids=["plain", "rho-entropy"])
def test_token_ppo_learner_matches_jax(rho_clip, entropy):
    """Loss, metrics and grads against JAX's; then one Adam step of each
    learner on JAX's grads. (Adam's first step is lr * g / (|g| + 1e-8):
    a grad near 1e-8 turns grads that agree within the tolerance into
    updates that do not, so the step is held on the same grads.)"""
    tp = _tparams(seed=2)
    jp = _jparams(tp)
    batch = _ppo_batch(seed=3)
    kw = dict(lr=1e-3, clip=0.2, rho_clip=rho_clip, entropy_coeff=entropy)
    jlearn = jexp.TokenPPOLearner(JCFG, params=jp, **kw)
    tlearn = TokenPPOLearner(TCFG, params=tp, device="cpu", **kw)
    with jax.default_matmul_precision("highest"):
        jgrads, jm = jlearn.compute_gradients(batch)
    tgrads, tm = tlearn.compute_gradients(batch)
    assert set(tm) == set(jm)
    for k in jm:
        np.testing.assert_allclose(tm[k], jm[k], rtol=1e-5, atol=1e-6,
                                   err_msg=k)
    for a, b in zip(_host_leaves(tgrads), _jleaves(jgrads)):
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-5, atol=1e-6)
    with jax.default_matmul_precision("highest"):
        jlearn.apply_gradients(jgrads)
    tlearn.apply_gradients(params_from_numpy(jax.device_get(jgrads),
                                             "cpu"))
    for a, b in zip(_host_leaves(tlearn.get_weights()),
                    _jleaves(jlearn.get_weights())):
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-5, atol=1e-6)


def test_adam_is_optax_adam():
    import optax

    from ray_tpu_torch.rl.experience import _adam

    rng = np.random.default_rng(5)
    p = {"a": rng.standard_normal((3, 4)).astype(np.float32),
         "b": rng.standard_normal(5).astype(np.float32)}
    opt = optax.adam(1e-2)
    jp, js = jax.tree.map(jnp.asarray, p), None
    js = opt.init(jp)
    tp = {k: torch.from_numpy(v.copy()) for k, v in p.items()}
    tadam = _adam(1e-2)
    ts = tadam.init(tp)
    for step in range(3):
        g = {k: rng.standard_normal(v.shape).astype(np.float32)
             for k, v in p.items()}
        upd, js = opt.update(jax.tree.map(jnp.asarray, g), js, jp)
        jp = optax.apply_updates(jp, upd)
        ts = tadam.apply_([torch.from_numpy(g["a"]),
                           torch.from_numpy(g["b"])], ts, tp)
    for k in p:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                   rtol=1e-6, atol=1e-7)
    assert ts.count == 3


def test_token_ppo_learner_descends_its_surrogate():
    buf = ExperienceBuffer()
    rng = np.random.default_rng(0)
    for n in range(4):
        toks = [int(t) for t in rng.integers(1, 32, size=4)]
        buf.add(SequenceRecord(
            prompt=[1 + n, 2], tokens=toks,
            logprobs=np.full(4, -np.log(TCFG.vocab_size), np.float32),
            reward=float(n % 2), weight_version=0, staleness=0))
    batch = buf.to_batch()
    learner = TokenPPOLearner(TCFG, params=_tparams(), lr=1e-2,
                              device="cpu")
    losses = [learner.update_from_batch(batch)["total_loss"]]
    assert np.isfinite(losses[0])
    for _ in range(5):
        losses.append(learner.update_from_batch(batch)["total_loss"])
    assert losses[-1] < losses[0], f"surrogate did not descend: {losses}"
    from ray_tpu_torch._private import cuda_monitor

    assert cuda_monitor.program_stats("rl_ppo_grad")["flops"] > 0
    assert cuda_monitor.program_stats("rl_ppo_apply")["compiles"] >= 1
    # The measured step (dispatch to the metrics' fetch) feeds the gauge.
    assert learner._grad_fn._external_timing
    gauge = {dict(k).get("program"): v
             for _, k, v in mdefs.XLA_ACHIEVED_FLOPS.samples()}
    assert gauge["rl_ppo_grad"] > 0


def test_rollout_scheduler_staleness_clip_and_metrics():
    def fake_generate(prompt, max_new):
        return [5] * max_new, np.zeros(max_new, np.float32), 1

    sched = RolloutScheduler(fake_generate, trainer_version_fn=lambda: 4,
                             run="clip", staleness_clip=2)
    admitted = sched.collect([[1], [2]], 3, lambda p, t: 1.0)
    assert admitted == 0 and sched.dropped_stale == 2   # staleness 3 > 2
    assert len(sched.buffer) == 0
    clips = [e for e in flight.local_events(types=["rl.rollout_clip"])
             if e["subject"].get("run") == "clip"]
    assert clips and clips[-1]["attrs"]["staleness"] == 3
    gauge = {dict(k).get("run"): v
             for _, k, v in mdefs.RL_ROLLOUT_STALENESS.samples()}
    assert gauge["clip"] == 3
    sched2 = RolloutScheduler(fake_generate, trainer_version_fn=lambda: 2,
                              run="clip2", staleness_clip=2)
    assert sched2.collect([[1]], 3, lambda p, t: 1.0) == 1
    assert sched2.buffer.staleness() == [1]
    out = sched2.learner_phase(lambda: 42, cause="c")
    assert out == 42
    phases = [e for e in flight.local_events(
        types=["rl.learner_phase", "rl.learner_phase_done"])
        if e["subject"].get("run") == "clip2"]
    assert [e["type"] for e in phases][-2:] == ["rl.learner_phase",
                                                "rl.learner_phase_done"]
    assert phases[-1]["cause"] == phases[-2]["event_id"]
    batch = sched2.drain_batch()
    assert batch["actions"].shape == (3, 1) and len(sched2.buffer) == 0
    # Under an arbiter each learner phase journals a serve-to-train lease
    # of learner_chips for lease_s; the step runs whether or not it is
    # granted.
    from ray_tpu_torch.autoscaler import arbiter as arb

    class _Fixed:
        def __init__(self, kind, chips):
            self.kind, self.deployment, self.run = kind, kind, kind
            self.min_chips, self._chips = 1, chips

        def chips(self):
            return self._chips

        target_chips = chips

    pool = arb.ChipPoolArbiter(_Fixed("serve", 3), _Fixed("train", 1),
                               kv=arb.DictKv(), policy="manual")
    sched3 = RolloutScheduler(fake_generate, lambda: 0, run="lease3",
                              arbiter=pool, learner_chips=2, lease_s=7.5)
    assert sched3.learner_phase(lambda: 43) == 43
    (lease,) = pool.ledger.leases()
    assert (lease["donor"], lease["recipient"], lease["chips"],
            lease["lease_s"], lease["stage"]) == ("serve", "train", 2, 7.5,
                                                  arb.PENDING)
    started = [e for e in flight.local_events(types=["rl.learner_phase"])
               if e["subject"].get("run") == "lease3"]
    assert started[-1]["subject"]["lease_id"] == lease["lease_id"]

    class _Refusing:
        def request_handoff(self, donor, chips, lease_s=None):
            raise RuntimeError("no pool")

    sched4 = RolloutScheduler(fake_generate, lambda: 0, run="lease4",
                              arbiter=_Refusing())
    assert sched4.learner_phase(lambda: 44) == 44


# ------------------------------------- engine: tick-boundary weight swap
def _drive(eng, rid, max_ticks=400):
    for _ in range(max_ticks):
        finished = eng.step()
        if rid in finished:
            return finished[rid]
    raise AssertionError("request never finished")


def test_swap_params_mid_request_is_tick_boundary_and_tagged():
    eng = ContinuousBatcher(TCFG, params=_tparams(), num_slots=2,
                            max_len=64, device="cpu")
    assert eng.weight_version == 0
    rid = eng.submit(list(range(1, 6)), max_new_tokens=8)
    for _ in range(3):
        eng.step()
    v = eng.swap_params(_tparams(scale=0.5), version=None)
    assert v == 1 and eng.weight_version == 1
    tokens = _drive(eng, rid)
    assert len(tokens) == 8               # survived the swap, full budget
    rec = [b for b in eng.request_breakdowns if b["rid"] == rid][-1]
    assert rec["outcome"] == "finished"
    assert rec["weight_version"] == 0     # the version that admitted it
    rid2 = eng.submit([1, 2, 3], max_new_tokens=2)
    _drive(eng, rid2)
    rec2 = [b for b in eng.request_breakdowns if b["rid"] == rid2][-1]
    assert rec2["weight_version"] == 1


def test_fast_path_equals_slow_path_bit_identical(tmp_path):
    plane = CheckpointPlane(str(tmp_path), run="fastslow",
                            process_index=0, process_count=1)
    pub = WeightPublisher(run="fastslow", n_subscribers=1,
                          ckpt_plane=plane)
    try:
        sub = WeightSubscriber(pub.subscriber_spec(0), run="fastslow")
        trained = _tparams(seed=3, scale=0.9)
        manifest = pub.publish(trained, step=1)
        m, received = sub.poll(timeout=5.0)
        fast = ContinuousBatcher(TCFG, params=_tparams(), num_slots=2,
                                 max_len=64, device="cpu")
        fast.swap_params(received, version=int(m["version"]))
        cold = load_latest(str(tmp_path), run="fastslow",
                           step=int(manifest["version"]))
        cold = getattr(cold, "params", cold)
        _assert_tree_equal(received, cold)
        slow = ContinuousBatcher(TCFG, params=cold, num_slots=2,
                                 max_len=64, device="cpu")
        prompt = list(range(1, 9))
        out_fast = _drive(fast, fast.submit(prompt, max_new_tokens=12))
        out_slow = _drive(slow, slow.submit(prompt, max_new_tokens=12))
        assert out_fast == out_slow, "fast path diverged from slow path"
        assert np.array_equal(fast.score_logprobs(prompt, out_fast),
                              slow.score_logprobs(prompt, out_slow))
    finally:
        pub.destroy()
        plane.close()


def _wait(pred, timeout_s=20.0):
    import time

    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(0.02)
    return False


def test_deployment_weight_sync_fast_then_slow_path(tmp_path):
    from ray_tpu_torch.llm import ContinuousLlamaDeployment

    plane = CheckpointPlane(str(tmp_path), run="dep",
                            process_index=0, process_count=1)
    kv = {}
    pub = WeightPublisher(run="dep", ckpt_plane=plane, kv=kv)
    dep = ContinuousLlamaDeployment._cls_or_fn(
        config=TCFG, params=_tparams(), num_slots=2, max_len=64,
        device="cpu")
    try:
        dep.enable_weight_sync(pub.subscriber_spec(0), run="dep",
                               poll_s=0.02, kv=kv)
        m1 = pub.publish(_tparams(seed=1), step=0)
        assert _wait(lambda: dep.weight_version() == 1)
        swaps = [e for e in flight.local_events(types=["rl.weight_swap"])
                 if e["subject"].get("run") == "dep"]
        assert swaps[-1]["cause"] == m1["event_id"]
        assert swaps[-1]["attrs"]["swap_cause"] == "publish"
        assert set(dep.sync_timing()) == {"read_s", "crc_s", "swap_s"}
        # The writer goes away: the ladder restores the newest
        # manifest's checkpoint (found through the KV mirror).
        dep.disable_weight_sync()
        pub2 = WeightPublisher(run="dep", ckpt_plane=plane, kv=kv)
        pub2.version = 1
        pub2.publish(_tparams(seed=2), step=1)
        dep.enable_weight_sync(pub.subscriber_spec(0), run="dep",
                               poll_s=0.02, kv=kv)
        pub.close()
        assert _wait(lambda: dep.weight_version() == 2)
        swaps = [e for e in flight.local_events(types=["rl.weight_swap"])
                 if e["subject"].get("run") == "dep"]
        assert swaps[-1]["attrs"]["swap_cause"] == "fallback"
        want = _host_leaves(_tparams(seed=2))
        got = _host_leaves(dep.batcher.params)
        assert all(torch.equal(a, b) for a, b in zip(want, got))
        assert _counter_value(mdefs.RL_SWAPS, run="dep",
                              cause="fallback") >= 1
        # And on command, the slow path of a given manifest.
        m3 = pub2.publish(_tparams(seed=5), step=2)
        dep.disable_weight_sync()
        assert dep.restore_weights(m3) == 3
        pub2.destroy()
    finally:
        dep.disable_weight_sync()
        dep.close()
        pub.destroy()
        plane.close()


# --------------------------------------------------- on the card by default
@pytest.mark.skipif(torch.cuda.is_available(), reason="a card is present")
def test_entry_points_default_to_the_card():
    from ray_tpu_torch.rllib import LearnerGroup

    import torch_rl_helpers as h

    with pytest.raises(RuntimeError, match="CUDA"):
        TokenPPOLearner(TCFG)
    with pytest.raises(RuntimeError, match="card"):
        LearnerGroup(h.build_tiny_learner)
    with pytest.raises(ValueError, match="module level"):
        LearnerGroup(lambda: None, use_gpu=False)


def test_mesh_placed_subscriber_raise_names_its_roadmap_entry():
    """A generator's params placed on a mesh are not RLlib: the stand-in
    names ROADMAP.md's entry of its own (item 10b)."""
    with pytest.raises(NotImplementedError, match=r"queue A, item 10b$"):
        WeightSubscriber(None, target_shardings={"w": None})

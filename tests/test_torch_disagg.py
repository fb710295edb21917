"""Port parity: the prefill/decode split (roles, KV export and import over
the JAX wire format, reservations, request records, pressure snapshot)
in ray_tpu_torch against the JAX package's, on the tiny fp32 config with
the same weights on both sides.

Mirrors every engine-level case of ``tests/test_disagg_serve.py`` on the
port (the plain attention route; the CUDA kernel's cases are the ``gpu``
tests in ``tests/test_torch_kernels_gpu.py``), with the port's own
``LlamaGenerator`` as the sequential reference, and carries payloads
across the two packages in both directions: the staging layouts are
equal entry for entry, and a request prefilled by one package and
decoded by the other gives the JAX colocated engine's greedy tokens.
"""

import os
import re
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import continuous_batching as jcb
from ray_tpu.models import llama as jl
from ray_tpu.serve import kv_transfer as jkt
from ray_tpu_torch._private import chaos
from ray_tpu_torch.interop import params_to_numpy
from ray_tpu_torch.models import continuous_batching as tcb
from ray_tpu_torch.models import inference as tinf
from ray_tpu_torch.models import llama as tl
from ray_tpu_torch.models import paged_kv as tkv
from ray_tpu_torch.serve import kv_transfer
from ray_tpu_torch.serve.recovery import RequestJournal

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JCFG = jl.LlamaConfig.tiny(dtype=jnp.float32)
TCFG = tl.LlamaConfig.tiny(dtype=torch.float32)
GEOMETRY = dict(num_slots=4, max_len=128, block_size=16, num_blocks=64)


@pytest.fixture(scope="module")
def setup():
    # The port draws the weights and JAX gets the same numbers through
    # numpy (JAX's eager init costs seconds of per-op compiles).
    tp = tl.init_params(TCFG, torch.Generator().manual_seed(5), "cpu")
    jp = jax.tree.map(jnp.asarray, params_to_numpy(tp))
    gen = tinf.LlamaGenerator(TCFG, params=tp, max_len=128, device="cpu")
    return jp, tp, gen


def _reference(gen, prompt, n):
    return gen.generate([list(prompt)], max_new_tokens=n)[0].tolist()


def _ints(rng, n):
    return list(map(int, rng.integers(1, 250, size=n)))


def _engine(tp, role, **kw):
    return tcb.ContinuousBatcher(TCFG, params=tp, paged=True, role=role,
                                 device="cpu", **{**GEOMETRY, **kw})


@pytest.fixture(scope="module")
def jengine(setup):
    """JAX engines by (role, settings), made once and shared: an engine is
    idle again after each use, and its compiled programs are what a JAX
    engine costs."""
    jp = setup[0]
    pool = {}

    def get(role, **kw):
        kw.setdefault("use_decode_kernel", False)
        key = (role, tuple(sorted(kw.items())))
        if key not in pool:
            pool[key] = jcb.ContinuousBatcher(
                JCFG, params=jp, paged=True, role=role,
                **{**GEOMETRY, **kw})
        assert not pool[key].has_work()
        return pool[key]
    return get


def _park(pre, prompt, max_new):
    """Submit on a prefill-role engine and run until the request parks
    with handoff-ready KV; returns its id."""
    rid = pre.submit(list(prompt), max_new_tokens=max_new)
    pre.run_to_completion()
    assert rid in pre.handoff_ready(), "request never parked for handoff"
    return rid


def _ints_out(out):
    return [int(t) for t in out]


# ----------------------------------------------- export/import parity

@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
def test_export_import_roundtrip_bit_parity(setup, kv_dtype):
    """The imported blocks are byte for byte the exported ones (K/V and,
    int8, the fp32 scale sidecars), through gather, staging and scatter;
    only the ceil(prompt/bs) prompt blocks ship."""
    _, tp, _ = setup
    prompt = _ints(np.random.default_rng(50), 33)   # 2 full blocks + tail
    pre = _engine(tp, "prefill", kv_dtype=kv_dtype)
    dst = _engine(tp, "decode", kv_dtype=kv_dtype)
    payload = kv_transfer.export_kv(pre, _park(pre, prompt, 6))
    raw = bytes(payload["staging"])
    layout = payload["layout"]
    assert isinstance(payload["staging"], np.ndarray)
    assert payload["staging"].dtype == np.uint8
    assert payload["crc32"] and payload["nbytes"] == len(raw)
    assert payload["num_blocks"] == 3
    assert [e[0] for e in layout] == (
        ["k", "v", "k_scale", "v_scale"] if kv_dtype == "int8"
        else ["k", "v"])
    assert payload["breakdown"]["export_s"] >= 0
    drid = kv_transfer.import_kv(dst, payload)
    slot = next(s for s, st in dst._slots.items() if st["rid"] == drid)
    blocks = dst._slot_blocks[slot][:payload["num_blocks"]]
    staged2, layout2 = dst.cache.gather_blocks(blocks)
    assert bytes(staged2) == raw and layout2 == layout
    assert pre.handoff_exports == dst.handoff_imports == 1


def test_import_rejects_corrupt_and_mismatched_payloads(setup):
    _, tp, _ = setup
    prompt = _ints(np.random.default_rng(51), 32)
    pre = _engine(tp, "prefill")
    dst = _engine(tp, "decode")
    payload = kv_transfer.export_kv(pre, _park(pre, prompt, 4))
    free0 = dst.allocator.free_count
    bad = np.array(payload["staging"], copy=True)
    bad[0] ^= 0xFF
    with pytest.raises(ValueError, match="crc"):
        kv_transfer.import_kv(dst, {**payload, "staging": bad})
    other = _engine(tp, "decode", block_size=32, num_blocks=32)
    with pytest.raises(ValueError, match="geometry|block_size"):
        kv_transfer.import_kv(other, payload)
    with pytest.raises(ValueError, match="kv_dtype"):
        kv_transfer.import_kv(_engine(tp, "decode", kv_dtype="int8"),
                              payload)
    with pytest.raises(ValueError, match="version"):
        kv_transfer.import_kv(dst, {**payload, "version": -1})
    with pytest.raises(ValueError, match="max_len"):
        kv_transfer.import_kv(dst, {**payload, "max_new": 120})
    # The version check comes first, then the crc (JAX's order).
    with pytest.raises(ValueError, match="version"):
        kv_transfer.import_kv(dst, {**payload, "version": 2,
                                    "staging": bad})
    # Nothing was taken by a refused import.
    assert dst.allocator.free_count == free0 and not dst._slots
    # A block count that disagrees with the layout is refused by the
    # scatter (JAX's count check).
    with pytest.raises(ValueError, match="blocks"):
        dst.cache.scatter_blocks([1, 2, 3], payload["staging"],
                                 payload["layout"])


def test_role_knob_guards(setup):
    jp, tp, _ = setup
    with pytest.raises(ValueError, match="role"):
        _engine(tp, "bogus")
    # Roles need the paged plane, in both packages.
    with pytest.raises(ValueError, match="paged"):
        tcb.ContinuousBatcher(TCFG, params=tp, paged=False, role="prefill",
                              device="cpu")
    with pytest.raises(ValueError, match="paged"):
        jcb.ContinuousBatcher(JCFG, params=jp, paged=False, role="prefill")
    pre = _engine(tp, "prefill")
    dst = _engine(tp, "decode")
    assert (pre.role, dst.role, _engine(tp, None).role) == (
        "prefill", "decode", "both")
    with pytest.raises(ValueError):
        pre.reserve_import(16, 4)
    with pytest.raises(ValueError):
        pre.import_kv_payload({"version": -1})
    rid = dst.submit(_ints(np.random.default_rng(52), 8), max_new_tokens=2)
    dst.run_to_completion()
    assert rid not in dst.handoff_ready()       # decode role never parks
    with pytest.raises((ValueError, KeyError)):
        dst.export_kv_payload(rid)
    with pytest.raises(KeyError):
        pre.export_kv_payload(12345)


def test_role_from_env(setup, monkeypatch):
    _, tp, _ = setup
    monkeypatch.setenv("RAY_TPU_SERVE_ROLE", "Decode")
    assert _engine(tp, None).role == "decode"
    assert _engine(tp, "both").role == "both"     # the argument wins


def test_reservation_lifecycle_and_ttl_sweep(setup, monkeypatch):
    """Reservations pin blocks for an incoming import; unspent tickets
    expire by TTL and cancelled ones free at once."""
    _, tp, _ = setup
    dst = _engine(tp, "decode")
    free0 = dst.allocator.free_count
    res = dst.reserve_import(32, 8)
    assert res is not None and dst.allocator.free_count == free0 - 3
    assert dst._import_reservations[res]["blocks"]
    assert dst.cancel_reservation(res)
    assert dst.allocator.free_count == free0
    res2 = dst.reserve_import(16, 4)
    assert res2 is not None
    monkeypatch.setenv("RAY_TPU_KV_RESERVE_TTL_S", "0")
    time.sleep(0.01)
    assert dst.sweep_reservations() == 1
    assert dst.allocator.free_count == free0
    assert not dst.cancel_reservation(res2)     # already swept
    monkeypatch.setenv("RAY_TPU_KV_RESERVE_TTL_S", "30")
    assert dst.reserve_import(16 * 64, 0) is None   # more than the arena


def test_reservation_spent_by_import(setup):
    """An import takes its reservation's blocks (the surplus goes back);
    a reservation sized for a smaller request goes back whole and the
    import grabs afresh."""
    _, tp, gen = setup
    prompt = _ints(np.random.default_rng(56), 20)
    pre = _engine(tp, "prefill")
    dst = _engine(tp, "decode")
    free0 = dst.allocator.free_count
    big = dst.reserve_import(64, 30)            # 6 blocks for a 3-block need
    rid = _park(pre, prompt, 5)
    drid = kv_transfer.transfer_inproc(pre, dst, rid, reservation=big)
    assert not dst._import_reservations
    assert dst.allocator.free_count == free0 - 2   # ceil(25 / 16)
    assert dst.run_to_completion()[drid] == _reference(gen, prompt, 5)
    small = dst.reserve_import(8, 1)
    drid = kv_transfer.transfer_inproc(pre, dst, _park(pre, prompt, 5),
                                       reservation=small)
    assert not dst._import_reservations
    assert dst.run_to_completion()[drid] == _reference(gen, prompt, 5)
    assert dst.pressure_snapshot()["import_reservations"] == 0


def test_pressure_snapshot_reports_role_fields(setup, jengine):
    _, tp, _ = setup
    pre = _engine(tp, "prefill")
    dst = _engine(tp, "decode")
    both = _engine(tp, "both")
    want = set(jengine("decode").pressure_snapshot())
    for eng, role in ((pre, "prefill"), (dst, "decode"), (both, "both")):
        snap = eng.pressure_snapshot()
        assert set(snap) == want
        assert snap["role"] == role
    assert set(tcb.ContinuousBatcher(TCFG, params=tp, paged=False,
                                     device="cpu").pressure_snapshot()) \
        == want
    assert dst.pressure_snapshot()["kv_blocks_importable"] == 63
    res = dst.reserve_import(32, 8)
    snap = dst.pressure_snapshot()
    assert snap["kv_blocks_importable"] == 60
    assert snap["import_reservations"] == 1
    dst.cancel_reservation(res)
    # A prefill engine's backlog counts queued prompts and parked exports.
    rng = np.random.default_rng(57)
    rid = _park(pre, _ints(rng, 20), 4)
    pre.submit(_ints(rng, 9), max_new_tokens=3)
    snap = pre.pressure_snapshot()
    assert snap["handoff_ready"] == 1 and snap["queue_depth"] == 1
    assert snap["prefill_queue_tokens"] == 29
    assert snap["inflight_prefill_tokens"] == 9
    pre.abandon_handoff(rid)


def test_import_inserts_prefix_into_radix_shareable(setup):
    """The transferred prefix is in the decode engine's radix index on
    arrival: a follow-up request sharing the prompt matches it instead
    of prefilling it again."""
    _, tp, gen = setup
    rng = np.random.default_rng(53)
    shared = _ints(rng, 32)
    pre = _engine(tp, "prefill", prefix_cache=True)
    dst = _engine(tp, "decode", prefix_cache=True)
    drid = kv_transfer.transfer_inproc(pre, dst, _park(pre, shared, 5))
    assert dst.run_to_completion()[drid] == _reference(gen, shared, 5)
    twin = shared + _ints(rng, 3)
    rid2 = dst.submit(twin, max_new_tokens=4)
    assert dst.run_to_completion()[rid2] == _reference(gen, twin, 4)
    assert dst.prefix_hit_tokens == 32 and dst.prefix_hit_rate > 0


def test_journal_gate_and_unported_channel(setup):
    """receive_handoff refuses a manifest the router never journaled;
    past the gate, send_handoff -> stamp -> receive_handoff lands the
    request through a shm channel (its segment unlinked by the reader)
    with the generator's tokens, and the export's chaos site fires in
    this process."""
    _, tp, gen = setup
    dst = _engine(tp, "decode")
    with pytest.raises(RuntimeError, match="journal"):
        kv_transfer.receive_handoff(dst, {"channel": None})
    pre = _engine(tp, "prefill")
    prompt = _ints(np.random.default_rng(58), 20)
    rid = _park(pre, prompt, 4)
    chaos.configure("delay_transfer:stage=export,secs=0.001", seed=1)
    try:
        manifest = kv_transfer.send_handoff(pre, rid)
        (fired,) = chaos.injection_log()
    finally:
        chaos.configure(None)
    assert fired["coords"] == {"stage": "export", "rid": rid}
    assert rid not in pre.handoff_ready()       # exported
    assert "staging" not in manifest and manifest["nbytes"] > 0
    segment = f"/dev/shm{manifest['channel'].name}"
    assert os.path.exists(segment)
    with pytest.raises(RuntimeError, match="journal"):
        kv_transfer.receive_handoff(dst, manifest)
    drid = kv_transfer.receive_handoff(dst, {**manifest, "journaled": True})
    assert not os.path.exists(segment)
    assert dst.run_to_completion()[drid] == _reference(gen, prompt, 4)
    (record,) = [r["handoff"] for r in dst.request_breakdowns
                 if r.get("handoff")]
    assert record["channel_s"] > 0 and record["import_s"] > 0


def test_handoff_noted_once_on_a_journal(setup):
    """transfer_inproc notes exactly one handoff on the port's
    RequestJournal, and a repeated note of the same attempt is the same
    entry."""
    _, tp, gen = setup
    prompt = _ints(np.random.default_rng(54), 32)
    pre = _engine(tp, "prefill")
    dst = _engine(tp, "decode")
    journal = RequestJournal("llm", "generate",
                             {"prompt_token_ids": prompt, "max_tokens": 4})
    drid = kv_transfer.transfer_inproc(pre, dst, _park(pre, prompt, 4),
                                       journal=journal)
    assert dst.run_to_completion()[drid] == _reference(gen, prompt, 4)
    assert len(journal.handoffs) == 1
    entry = journal.handoffs[0]
    assert entry["attempt"] == 0 and entry["num_blocks"] == 2
    assert entry["nbytes"] > 0 and entry["crc32"]
    assert journal.note_handoff({"crc32": 0, "attempt": 0}) is entry


def test_abandoned_handoff_releases_blocks(setup):
    _, tp, _ = setup
    rng = np.random.default_rng(55)
    # Prefix cache off: abandoned blocks free outright (on, they would
    # deref into the LRU instead).
    pre = _engine(tp, "prefill", prefix_cache=False)
    free0 = pre.allocator.free_count
    rid = _park(pre, _ints(rng, 32), 4)
    assert pre.allocator.free_count < free0
    assert pre.abandon_handoff(rid)
    assert pre.allocator.free_count == free0
    assert not pre.abandon_handoff(rid)
    # cancel() of a parked request drops its handoff too (its first
    # token was already read, so cancel finds nothing else to drop).
    on = _engine(tp, "prefill", prefix_cache=True)
    rid = _park(on, _ints(rng, 40), 4)
    on.cancel(rid)
    assert not on.handoff_ready()
    assert on.kv_block_stats()["cached"] == 2      # indexed blocks park
    assert on.allocator.free_count + 2 == on.num_blocks - 1


# ------------------------------------------ colocated-vs-split parity

def _run_colocated(make, reqs, **kw):
    eng = make("both", **kw)
    rids = [eng.submit(list(p), max_new_tokens=m) for p, m in reqs]
    out = eng.run_to_completion()
    return [_ints_out(out[r]) for r in rids]


def _run_split(make, transfer, reqs, **kw):
    """Every request prefills on one engine, crosses the transfer plane
    and decodes on another (a request that finished at its first token
    stays on the prefill side)."""
    pre, dec = make("prefill", **kw), make("decode", **kw)
    rids = [pre.submit(list(p), max_new_tokens=m) for p, m in reqs]
    pre_out = pre.run_to_completion()
    assert pre.base_tick_count == 0             # a prefill engine never ticks
    mapped = [("d", transfer(pre, dec, r)) if r in pre.handoff_ready()
              else ("p", r) for r in rids]
    dec_out = dec.run_to_completion()
    return [_ints_out(dec_out[r] if side == "d" else pre_out[r])
            for side, r in mapped]


def _port_maker(tp):
    return lambda role, **kw: _engine(tp, role, **kw)


def _matrix_requests():
    rng = np.random.default_rng(60)
    shared = _ints(rng, 32)
    return [(shared + _ints(rng, 4), 6), (shared + _ints(rng, 2), 5),
            (_ints(rng, 17), 7), (_ints(rng, 9), 1)]


def test_split_parity_smoke(setup):
    """The two most entangled legs (buffered sync with the prefix cache,
    and int8 per-tick sync): split equals colocated, and the model-dtype
    arena the sequential generator; a request of one token finishes on
    the prefill side."""
    _, tp, gen = setup
    reqs = _matrix_requests()
    make = _port_maker(tp)
    kw = dict(sync_every=4, prefix_cache=True)
    split = _run_split(make, kv_transfer.transfer_inproc, reqs, **kw)
    assert split == _run_colocated(make, reqs, **kw) == \
        [_reference(gen, p, m) for p, m in reqs]
    kw8 = dict(kv_dtype="int8")
    assert _run_split(make, kv_transfer.transfer_inproc, reqs, **kw8) == \
        _run_colocated(make, reqs, **kw8)


def _split_parity_matrix(jengine, tp, gen, use_kernel):
    reqs = _matrix_requests()
    refs = [_reference(gen, p, m) for p, m in reqs]
    make = _port_maker(tp)

    def jmake(role, **kw):
        return jengine(role, use_decode_kernel=use_kernel, **kw)

    for kv_dtype in ("bf16", "int8"):
        for sync_every in (1, 4):
            for prefix in (False, True):
                kw = dict(kv_dtype=kv_dtype, sync_every=sync_every,
                          prefix_cache=prefix)
                tag = (use_kernel, kv_dtype, sync_every, prefix)
                split = _run_split(make, kv_transfer.transfer_inproc, reqs,
                                   **kw)
                assert split == _run_colocated(make, reqs, **kw), tag
                assert split == _run_colocated(jmake, reqs, **kw), tag
                if kv_dtype == "bf16":
                    assert split == refs, tag


@pytest.mark.slow
def test_split_parity_matrix(setup, jengine):
    """Split equals colocated (the port's and JAX's engines) across
    model-dtype/int8 arenas x sync_every {1, 4} x prefix cache on/off."""
    _, tp, gen = setup
    _split_parity_matrix(jengine, tp, gen, use_kernel=False)


@pytest.mark.slow
def test_split_parity_matrix_paged_kernel(setup, jengine, pallas_interpret):
    """The same matrix with JAX's colocated engine on its paged Pallas
    kernel (interpret mode on the CPU)."""
    _, tp, gen = setup
    _split_parity_matrix(jengine, tp, gen, use_kernel=True)


@pytest.mark.parametrize("spec", ["self", "external"])
def test_split_with_spec_decode_on_the_decode_side(setup, spec):
    """A decode engine with speculative decode (k=2): self-draft over the
    imported blocks, or an external drafter (the target's own weights, so
    its drafts are accepted) that prefills the imported prompt into its
    own cache; tokens equal the generator's."""
    _, tp, gen = setup
    reqs = _matrix_requests()[:3]
    kw = dict(spec_k=2, spec_draft_layers=1, spec_adaptive=False)
    if spec == "external":
        kw["drafter"] = tinf.ExternalLlamaDrafter(TCFG, params=tp)
    pre = _engine(tp, "prefill")
    dec = _engine(tp, "decode", **kw)
    rids = [pre.submit(list(p), max_new_tokens=m) for p, m in reqs]
    pre.run_to_completion()
    drids = [kv_transfer.transfer_inproc(pre, dec, r) for r in rids]
    out = dec.run_to_completion()
    assert [out[r] for r in drids] == [_reference(gen, p, m)
                                       for p, m in reqs]
    assert dec.spec_tick_count > 0
    if spec == "external":
        assert dec.spec_accept_rate > 0.5


# --------------------------------------------- across the two packages

@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
def test_cross_package_handoffs(setup, jengine, kv_dtype):
    """A JAX prefill engine's payload decodes on the port's decode
    engine, and a port payload on JAX's: both give JAX's colocated greedy
    tokens, and the two packages' layouts are equal entry for entry."""
    _, tp, _ = setup
    reqs = _matrix_requests()[:2]     # one prefill group: one JAX compile
    kw = dict(kv_dtype=kv_dtype, prefix_cache=False)
    want = _run_colocated(jengine, reqs, **kw)
    payloads = {}

    def transfer(src, dst, rid):
        payload = (jkt if isinstance(src, jcb.ContinuousBatcher)
                   else kv_transfer).export_kv(src, rid)
        payloads.setdefault(type(src).__module__, []).append(
            {k: v for k, v in payload.items() if k != "staging"})
        mod = jkt if isinstance(dst, jcb.ContinuousBatcher) else kv_transfer
        return mod.import_kv(dst, payload)

    def jax_to_port(role, **k):
        return (jengine(role, **k) if role == "prefill"
                else _engine(tp, role, **k))

    def port_to_jax(role, **k):
        return (_engine(tp, role, **k) if role == "prefill"
                else jengine(role, **k))

    assert _run_split(jax_to_port, transfer, reqs, **kw) == want
    assert _run_split(port_to_jax, transfer, reqs, **kw) == want
    ours, theirs = payloads[tcb.__name__], payloads[jcb.__name__]
    assert len(ours) == len(theirs) == 2
    assert tcb.HANDOFF_MANIFEST_VERSION == jcb.HANDOFF_MANIFEST_VERSION
    for a, b in zip(ours, theirs):
        # Field for field JAX's manifest; the bytes (so the crc) differ
        # by the two prefills' summation orders.
        assert set(a) == set(b)
        for key in set(a) - {"rid", "crc32", "breakdown", "layout"}:
            assert a[key] == b[key], key
        assert [tuple(e) for e in a["layout"]] == \
            [tuple(e) for e in b["layout"]]
        assert all(type(x) is int
                   for e in a["layout"] for x in (*e[2], e[3], e[4]))


def _midflight(make, transfer, prompts, max_new):
    """The router's drive: reserve on the decode engine, submit to the
    prefill engine, one prefill step, transfer what parked, one decode
    step; a request arrives every other round, so imports land while
    earlier requests decode."""
    pre, dec = make("prefill"), make("decode")
    queue = list(prompts)
    res, local, out = {}, {}, {}
    while queue or pre.has_work() or dec.has_work():
        if queue:
            p = queue.pop(0)
            ticket = dec.reserve_import(len(p), max_new)
            rid = pre.submit(p, max_new_tokens=max_new)
            res[rid] = ticket
        pre.step()
        for rid in pre.handoff_ready():
            local[rid] = transfer(pre, dec, rid, reservation=res.pop(rid))
        out.update(dec.step())
        out.update(dec.step())
    assert not dec._import_reservations and not pre.base_tick_count
    return [_ints_out(out[local[r]]) for r in sorted(local)]


def test_midflight_imports_match_jax(setup, jengine):
    """Imports that land while other slots decode, the same sequence of
    submits, steps and imports through both packages: the same tokens as
    JAX's, the generator's, and at sync_every=4 too (the port's import
    first applies the ticks in flight)."""
    _, tp, gen = setup
    rng = np.random.default_rng(61)
    prompts = [_ints(rng, n) for n in (40, 33, 50, 36, 60)]
    refs = [_reference(gen, p, 8) for p in prompts]
    jax_out = _midflight(lambda role: jengine(role, prefix_cache=False),
                         jkt.transfer_inproc, prompts, 8)
    assert jax_out == refs
    for sync_every in (1, 4):
        got = _midflight(
            lambda role: _engine(tp, role, sync_every=sync_every),
            kv_transfer.transfer_inproc, prompts, 8)
        assert got == jax_out, sync_every


def test_import_into_a_buffered_engine_takes_a_clean_boundary(setup):
    """With ticks in flight, an import first applies them: the host's
    state is then the device's, and the new slot uploads on the next
    step."""
    _, tp, gen = setup
    rng = np.random.default_rng(62)
    a, b = _ints(rng, 20), _ints(rng, 12)
    pre = _engine(tp, "prefill")
    dec = _engine(tp, "decode", sync_every=4)
    da = kv_transfer.transfer_inproc(pre, dec, _park(pre, a, 12))
    out = {}
    for _ in range(3):
        out.update(dec.step())
    assert dec._buf or dec._pending is not None
    db = kv_transfer.transfer_inproc(pre, dec, _park(pre, b, 6))
    assert not dec._buf and dec._pending is None and dec._dirty
    out.update(dec.run_to_completion())
    assert out[da] == _reference(gen, a, 12)
    assert out[db] == _reference(gen, b, 6)


# ------------------------------------------------------ request records

def test_request_breakdowns(setup, jengine):
    """Every request leaves a record with JAX's fields: a colocated one
    its queue/arena/prefill split and time a token; a parked prefill its
    "prefilled" outcome; an imported one the handoff split and the whole
    prompt as its prefix; cancel and reset their outcomes."""
    _, tp, _ = setup
    rng = np.random.default_rng(63)
    prompt = _ints(rng, 40)
    both = _engine(tp, "both")
    trace = {"trace_id": "t1", "request_id": "r1"}
    rid = both.submit(prompt, max_new_tokens=5, trace=trace)
    both.run_to_completion()
    (rec,) = both.request_breakdowns
    jdec = jengine("decode", prefix_cache=False)
    jpre = jengine("prefill", prefix_cache=False)
    jkt.transfer_inproc(jpre, jdec, _park(jpre, prompt, 3))
    jdec.run_to_completion()
    assert set(rec) == set(jdec.request_breakdowns[-1])
    assert (rec["rid"], rec["outcome"], rec["tokens"]) == (rid, "finished",
                                                           5)
    assert (rec["trace_id"], rec["request_id"]) == ("t1", "r1")
    assert rec["prompt_tokens"] == 40 and rec["prefix_tokens"] == 0
    assert rec["weight_version"] == 0 and rec["handoff"] is None
    for key in ("queue_s", "arena_wait_s", "prefill_s", "tpot_s"):
        assert rec[key] >= 0, key
    assert rec["ttft_s"] >= rec["prefill_s"]
    pre = _engine(tp, "prefill")
    dec = _engine(tp, "decode")
    drid = kv_transfer.transfer_inproc(pre, dec, _park(pre, prompt, 3))
    (parked,) = pre.request_breakdowns
    assert (parked["outcome"], parked["tokens"]) == ("prefilled", 1)
    dec.run_to_completion()
    (imp,) = dec.request_breakdowns
    assert (imp["rid"], imp["outcome"], imp["tokens"]) == (drid, "finished",
                                                           3)
    assert imp["prefix_tokens"] == imp["prompt_tokens"] == 40
    assert set(imp["handoff"]) == {"export_s", "import_s"}
    assert imp["handoff"]["import_s"] == imp["ttft_s"]
    assert imp["queue_s"] == imp["arena_wait_s"] == 0.0
    # cancel and reset close their requests' records.
    r1 = both.submit(prompt, max_new_tokens=5)
    assert both.cancel(r1)
    both.submit(prompt, max_new_tokens=5)
    both.step()
    both.reset()
    assert [r["outcome"] for r in both.request_breakdowns][1:] == [
        "evicted", "aborted"]
    assert not both._req_meta


def test_arena_wait_is_split_from_queue_wait(setup):
    """A head that waits on arena blocks with a slot free records arena
    wait; the wait ends when another request's blocks come back."""
    _, tp, _ = setup
    rng = np.random.default_rng(64)
    eng = _engine(tp, "both", num_blocks=5, prefix_cache=False)
    eng.submit(_ints(rng, 40), max_new_tokens=8)    # 3 of 4 blocks
    rid = eng.submit(_ints(rng, 30), max_new_tokens=8)
    eng.step()
    time.sleep(0.02)
    eng.run_to_completion()
    rec = next(r for r in eng.request_breakdowns if r["rid"] == rid)
    assert rec["arena_wait_s"] >= 0.02 and rec["queue_s"] < 0.02


# ------------------------------------------------------------ staging

def test_staging_round_trip_without_ml_dtypes(tmp_path):
    """The port's staging path builds no numpy bfloat16 dtype: with
    ml_dtypes blocked, a bf16 arena's blocks round-trip through a
    payload's bytes."""
    code = (
        "import sys\n"
        "sys.modules['ml_dtypes'] = None\n"
        "import zlib, torch\n"
        "from ray_tpu_torch.models import llama, paged_kv\n"
        "cfg = llama.LlamaConfig.tiny(dtype=torch.bfloat16)\n"
        "src = paged_kv.PagedKVCache.create(cfg, 6, 16, 'bf16', 'cpu')\n"
        "g = torch.Generator().manual_seed(0)\n"
        "for a in (src.k, src.v):\n"
        "    a.copy_(torch.randn(a.shape, generator=g))\n"
        "staging, layout = src.gather_blocks([4, 1])\n"
        "assert staging.dtype.name == 'uint8'\n"
        "assert [e[1] for e in layout] == ['bfloat16'] * 2\n"
        "dst = paged_kv.PagedKVCache.create(cfg, 6, 16, 'bf16', 'cpu')\n"
        "dst.scatter_blocks([2, 5], bytes(staging), layout)\n"
        "assert torch.equal(dst.k[:, [2, 5]], src.k[:, [4, 1]])\n"
        "assert torch.equal(dst.v[:, [2, 5]], src.v[:, [4, 1]])\n"
        "again, _ = dst.gather_blocks([2, 5])\n"
        "assert zlib.crc32(again) == zlib.crc32(staging)\n"
        "assert 'ml_dtypes' not in sys.modules or "
        "sys.modules['ml_dtypes'] is None\n"
        "print('ok')\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and "ok" in out.stdout, \
        out.stdout + out.stderr


def test_unpack_staging_views_the_buffer():
    """unpack_staging returns views of the buffer in the layout's dtypes
    and shapes, read from a JAX-style layout."""
    cfg = tl.LlamaConfig.tiny(dtype=torch.float32)
    cache = tkv.PagedKVCache.create(cfg, 4, 8, "int8", "cpu")
    cache.k_scale.copy_(torch.rand(cache.k_scale.shape))
    staging, layout = cache.gather_blocks([3])
    views = tkv.unpack_staging(staging, layout)
    assert views["k_scale"].dtype == torch.float32
    assert torch.equal(views["k_scale"], cache.k_scale[:, [3]])
    staging[layout[2][3]:layout[2][3] + 4] = 0
    assert float(views["k_scale"].reshape(-1)[0]) == 0.0   # a view


# --------------------------------------------------------------- lint

def test_payload_calls_only_through_kv_transfer():
    """Inside ray_tpu_torch, export_kv_payload and import_kv_payload are
    called only from ray_tpu_torch/serve/kv_transfer.py (their
    definitions aside), as JAX holds its package."""
    call = re.compile(r"\.(export_kv_payload|import_kv_payload)\s*\(")
    allowed = os.path.join(REPO, "ray_tpu_torch", "serve", "kv_transfer.py")
    found = set()
    for root, _, names in os.walk(os.path.join(REPO, "ray_tpu_torch")):
        for name in names:
            if not name.endswith(".py"):
                continue
            path = os.path.join(root, name)
            with open(path) as f:
                for n, line in enumerate(f, 1):
                    if call.search(line):
                        assert path == allowed, f"{path}:{n}: {line}"
                        found.add(call.search(line).group(1))
    assert found == {"export_kv_payload", "import_kv_payload"}

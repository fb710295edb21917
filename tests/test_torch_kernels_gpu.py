"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Every test here is marked ``gpu`` and skips without a CUDA device.
The file imports neither JAX nor ``ray_tpu``, so it also runs on a
machine that has only PyTorch:

    python -m pytest --noconftest -m gpu tests/test_torch_kernels_gpu.py
"""

import numpy as np
import pytest
import torch

from ray_tpu_torch.models import llama, mixtral, training
from ray_tpu_torch.models.paged_kv import GARBAGE_BLOCK, quantize_kv
from ray_tpu_torch.ops import attention as tfa
from ray_tpu_torch.ops import decode_attention as tda
from ray_tpu_torch.ops import moe
from ray_tpu_torch.ops import paged_decode_attention as tpda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode "
                    "(run `pytest -m gpu` on the card)")
    return torch.device("cuda")


def _paged_case(dev, kind, hq, hkv, d, bs, positions, nb_slot, seed=0,
                q_kind=None):
    """q, arena (each slot's logical blocks at permuted physical ids) and
    tables whose dead tail entries repeat the last live block; slot -1
    stands for a freed slot, its whole row on the garbage block."""
    rng = np.random.default_rng(seed)
    b = len(positions)
    nblocks = b * nb_slot + 1
    q = rng.standard_normal((b, hq, d)).astype(np.float32)
    k = rng.standard_normal((nblocks, bs, hkv, d)).astype(np.float32)
    v = rng.standard_normal((nblocks, bs, hkv, d)).astype(np.float32)
    tables = rng.permutation(np.arange(1, nblocks)).reshape(b, nb_slot)
    pos = np.array([max(p, 0) for p in positions], np.int32)
    for i, p in enumerate(positions):
        if p < 0:
            tables[i] = GARBAGE_BLOCK
        else:
            live = min(p // bs + 1, nb_slot)
            tables[i, live:] = tables[i, live - 1]
    dt = {"bf16": torch.bfloat16, "fp32": torch.float32}
    tq = torch.from_numpy(q).to(dev, dt[q_kind or ("fp32" if kind == "fp32"
                                                    else "bf16")])
    tk, tv = (torch.from_numpy(a).to(dev) for a in (k, v))
    ks = vs = None
    if kind == "int8":
        tk, ks = quantize_kv(tk)
        tv, vs = quantize_kv(tv)
    else:
        tk, tv = tk.to(dt[kind]), tv.to(dt[kind])
    return (tq, tk, tv, torch.from_numpy(tables.astype(np.int32)).to(dev),
            torch.from_numpy(pos).to(dev)), dict(k_scale=ks, v_scale=vs)


# (kind, q kind, hq, hkv, d, bs, positions, table entries per slot): the
# Llama-3-8B decode shape, every group tile (G = 1, 2, 4, 8 and G = 3, 12,
# which split a kv head's group over blocks), block sizes 16-128, head
# dims 40-256 (int8 rows of 40 bytes; fp32 at 256 takes three warps a
# block), positions at block edges, past the table (all entries live) and a
# freed slot (-1); long tables (128 entries, positions up to 8191, one slot
# alone), and a single slot at group tile 1 (the fewest blocks).
CASES = {
    "llama3-bf16": ("bf16", None, 32, 8, 128, 64,
                    (0, 63, 64, 700, 1023, 1500, 2047, -1), 32),
    "llama3-fp32": ("fp32", None, 32, 8, 128, 64,
                    (0, 63, 64, 700, 1023, 1500, 2047, -1), 32),
    "llama3-int8": ("int8", None, 32, 8, 128, 64,
                    (0, 63, 64, 700, 1023, 1500, 2047, -1), 32),
    "q-fp32-arena-bf16": ("bf16", "fp32", 32, 8, 128, 64, (5, 130, 511), 8),
    "g1-bs16": ("bf16", None, 8, 8, 128, 16, (15, 16, 17, 200), 16),
    "g2-overrun": ("fp32", None, 4, 2, 64, 32, (31, 32, 127, 500), 4),
    "g3": ("bf16", None, 24, 8, 128, 64, (0, 100, 300), 6),
    "g8-bs128": ("bf16", None, 64, 8, 128, 128, (127, 128, 1000), 8),
    "g12-int8": ("int8", None, 48, 4, 128, 64, (64, 333), 6),
    "d40-int8": ("int8", None, 8, 2, 40, 32, (1, 95, 96), 4),
    "d256-fp32": ("fp32", None, 16, 4, 256, 64, (63, 700), 12),
    "d256-bf16": ("bf16", None, 16, 2, 256, 64, (0, 64, 767), 12),
    "long-bf16": ("bf16", None, 32, 8, 128, 64, (0, 2047, 5000, 8191), 128),
    "long-alone-bf16": ("bf16", None, 32, 8, 128, 64, (8191,), 128),
    "long-int8": ("int8", None, 32, 8, 128, 64, (1, 4095, 8191), 128),
    "long-fp32": ("fp32", None, 32, 8, 128, 64, (64, 8191), 128),
    "g1-one-slot-bf16": ("bf16", None, 8, 8, 128, 64, (3000,), 64),
    # D = 8 at group tile 8: an int8 row (24 bytes with its pad) is
    # smaller than a token's 8 fp32 probabilities.
    "d8-g8-int8": ("int8", None, 16, 2, 8, 16, (0, 31, 32, 100, 255), 16),
    "d8-g8-bf16": ("bf16", None, 16, 2, 8, 16, (0, 31, 32, 100, 255), 16),
}


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(CASES))
def test_paged_kernel_matches_plain(cuda_device, name):
    kind, q_kind, hq, hkv, d, bs, positions, nb = CASES[name]
    args, kw = _paged_case(cuda_device, kind, hq, hkv, d, bs, positions,
                           nb, q_kind=q_kind)
    before = tpda.paged_decode_attention.launches
    out = tpda.paged_decode_attention(*args, **kw)
    assert tpda.paged_decode_attention.launches == before + 1
    ref = tpda.paged_decode_attention(*args, use_kernel=False, **kw)
    torch.cuda.synchronize()
    assert out.dtype == ref.dtype and out.shape == ref.shape
    # fp32: the same math in another summation order. bf16 outputs: one
    # bf16 rounding (2^-8 relative) of nearly equal fp32 values.
    atol, rtol = (1e-5, 0.0) if out.dtype == torch.float32 else (2e-2, 2e-2)
    torch.testing.assert_close(out.float(), ref.float(), atol=atol,
                               rtol=rtol)


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["bf16", "fp32", "int8"])
def test_paged_kernel_chunk_edges(cuda_device, kind):
    # Positions one before, on and one after the edges of the split
    # chunks the host picks for these shapes on this card.
    hq, hkv, d, bs, nb = 32, 8, 128, 64, 32
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    _, _, c = tpda.paged_layout(6, hq, hkv, nb, bs, sms)
    positions = (c - 2, c - 1, c, 2 * c - 1, 2 * c, nb * bs - 1)
    args, kw = _paged_case(cuda_device, kind, hq, hkv, d, bs, positions, nb,
                           seed=3)
    out = tpda.paged_decode_attention(*args, **kw)
    ref = tpda.paged_decode_attention(*args, use_kernel=False, **kw)
    torch.cuda.synchronize()
    atol, rtol = (1e-5, 0.0) if out.dtype == torch.float32 else (2e-2, 2e-2)
    torch.testing.assert_close(out.float(), ref.float(), atol=atol,
                               rtol=rtol)


def _flash_case(dev, dtype, b, sq, sk, hq, hkv, d, seed=0):
    rng = np.random.default_rng(seed)
    q, do = (rng.standard_normal((b, sq, hq, d)).astype(np.float32)
             for _ in range(2))
    k, v = (rng.standard_normal((b, sk, hkv, d)).astype(np.float32)
            for _ in range(2))
    return [torch.from_numpy(a).to(dev, dtype) for a in (q, k, v, do)]


# (dtype, causal, b, sq, sk, hq, hkv, d): GQA groups 1/2/4/8, D 64 and
# 128, cross-length causal (bottom-right mask), lengths that are not a
# multiple of the 64-row tile, the Llama-3-8B head layout and its full
# training attention shape. bf16 runs the tensor-core forward, dq and
# dk/dv, fp32 the CUDA-core kernels; every bf16 case holds dq at 2e-2,
# D=64 among them at lengths that are multiples of 64 and ragged ones.
FLASH_CASES = {
    "g1-causal-fp32": (torch.float32, True, 2, 256, 256, 4, 4, 128),
    "g2-causal-bf16": (torch.bfloat16, True, 2, 256, 256, 4, 2, 128),
    "g4-noncausal-fp32": (torch.float32, False, 1, 192, 320, 8, 2, 128),
    "g8-causal-bf16": (torch.bfloat16, True, 1, 512, 512, 8, 1, 128),
    "d64-causal-fp32": (torch.float32, True, 2, 128, 128, 4, 2, 64),
    "d64-noncausal-bf16": (torch.bfloat16, False, 1, 96, 160, 4, 1, 64),
    "cross-causal-fp32": (torch.float32, True, 1, 128, 384, 4, 2, 128),
    "cross-causal-bf16": (torch.bfloat16, True, 2, 64, 256, 8, 2, 128),
    "ragged-causal-fp32": (torch.float32, True, 1, 100, 100, 4, 2, 128),
    "ragged-cross-bf16": (torch.bfloat16, True, 1, 72, 200, 4, 4, 64),
    "llama3-causal-bf16": (torch.bfloat16, True, 1, 1024, 1024, 32, 8, 128),
    "llama3-train-causal-bf16": (torch.bfloat16, True, 2, 2048, 2048, 32, 8,
                                 128),
    "g4-d64-ragged-bf16": (torch.bfloat16, True, 2, 200, 200, 8, 2, 64),
    "g4-d64-ragged-cross-bf16": (torch.bfloat16, True, 1, 77, 333, 8, 2, 64),
    "d64-causal-bf16": (torch.bfloat16, True, 2, 256, 256, 4, 2, 64),
    "d64-cross-causal-bf16": (torch.bfloat16, True, 1, 128, 320, 8, 4, 64),
    "d64-ragged-noncausal-bf16": (torch.bfloat16, False, 1, 130, 70, 4, 2,
                                  64),
    "ragged-causal-bf16": (torch.bfloat16, True, 1, 100, 100, 4, 2, 128),
}


def _flash_tol(dtype):
    # fp32: the same fp32 math in another summation order. bf16 outputs:
    # one bf16 rounding (2^-8 relative) of nearly equal fp32 values.
    return (2e-5, 2e-5) if dtype == torch.float32 else (2e-2, 2e-2)


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(FLASH_CASES))
def test_flash_kernels_match_plain(cuda_device, name):
    dtype, causal, b, sq, sk, hq, hkv, d = FLASH_CASES[name]
    q, k, v, do = _flash_case(cuda_device, dtype, b, sq, sk, hq, hkv, d)
    scale = d ** -0.5
    before = dict(tfa.flash_attention.launches)
    out, lse = tfa.flash_fwd_cuda(q, k, v, scale=scale, causal=causal)
    grads = tfa.flash_bwd_cuda(q, k, v, out, lse, do, scale=scale,
                               causal=causal)
    assert {n: tfa.flash_attention.launches[n] - before[n]
            for n in before} == {"fwd": 1, "dq": 1, "dkv": 1}
    ref_out, ref_lse = tfa.flash_fwd_reference(q, k, v, scale=scale,
                                               causal=causal)
    ref_grads = tfa.flash_bwd_reference(q, k, v, ref_out, ref_lse, do,
                                        scale=scale, causal=causal)
    torch.cuda.synchronize()
    atol, rtol = _flash_tol(dtype)
    torch.testing.assert_close(lse, ref_lse, atol=2e-5, rtol=2e-5)
    for got, ref in zip((out,) + grads, (ref_out,) + ref_grads):
        assert got.dtype == ref.dtype and got.shape == ref.shape
        torch.testing.assert_close(got.float(), ref.float(), atol=atol,
                                   rtol=rtol)


# The kernel each dtype launches, by the name the profiler sees: bf16 on
# the tensor cores, fp32 on the CUDA cores.
FLASH_KERNEL_NAMES = {
    torch.bfloat16: {"fwd": "flash_fwd_kernel_sm90",
                     "dq": "flash_dq_kernel_sm90",
                     "dkv": "flash_dkv_kernel_sm90"},
    torch.float32: {"fwd": "flash_fwd_kernel", "dq": "flash_dq_kernel",
                    "dkv": "flash_dkv_kernel"},
}


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "fp32"])
def test_flash_dtype_launches_its_kernel(cuda_device, dtype):
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    q, k, v, do = _flash_case(cuda_device, dtype, 1, 128, 128, 4, 2, 128)
    kw = dict(scale=128 ** -0.5, causal=True)
    out, lse = tfa.flash_fwd_cuda(q, k, v, **kw)
    delta = tfa._delta(out, do)
    torch.cuda.synchronize()
    for which, launch in (
            ("fwd", lambda: tfa.flash_fwd_cuda(q, k, v, **kw)),
            ("dq", lambda: tfa.flash_dq_cuda(q, k, v, do, lse, delta, **kw)),
            ("dkv", lambda: tfa.flash_dkv_cuda(q, k, v, do, lse, delta,
                                               **kw))):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            launch()
            torch.cuda.synchronize()
        names = [e.key for e in prof.key_averages()
                 if e.device_type == DeviceType.CUDA and "flash_" in e.key]
        want = FLASH_KERNEL_NAMES[dtype][which]
        assert len(names) == 1 and want in names[0], (which, names)
        assert ("_sm90" in names[0]) == want.endswith("_sm90"), names
        assert tfa.kernel_route(which, dtype)[1].endswith("_sm90") == \
            want.endswith("_sm90")


@pytest.mark.gpu
def test_flash_attention_autograd_launches_kernels(cuda_device):
    q, k, v, do = _flash_case(cuda_device, torch.bfloat16, 2, 256, 256, 8,
                              2, 128)
    q, k, v = (t.requires_grad_() for t in (q, k, v))
    before = dict(tfa.flash_attention.launches)
    out = tfa.flash_attention(q, k, v, causal=True)
    grads = torch.autograd.grad(out, (q, k, v), do)
    assert {n: tfa.flash_attention.launches[n] - before[n]
            for n in before} == {"fwd": 1, "dq": 1, "dkv": 1}
    ref = tfa.flash_attention(q, k, v, causal=True, use_kernel=False)
    ref_grads = torch.autograd.grad(ref, (q, k, v), do)
    torch.cuda.synchronize()
    for got, want in zip((out,) + grads, (ref,) + ref_grads):
        torch.testing.assert_close(got.float(), want.float(), atol=2e-2,
                                   rtol=2e-2)


@pytest.mark.gpu
def test_trainer_on_card_launches_kernels_and_matches_cpu(cuda_device):
    # fp32 train steps through the kernels on the card against the plain
    # versions on the CPU from the same weights: the same math in
    # another summation order (attention, cuBLAS), 1e-4 relative.
    cfg = llama.LlamaConfig.tiny(
        dtype=torch.float32, vocab_size=512, hidden_size=256,
        intermediate_size=512, num_heads=4, num_kv_heads=2, head_dim=128,
        remat=True)
    params = llama.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    losses = {}
    for dev in ("cpu", cuda_device):
        trainer = training.ShardedTrainer(
            cfg, device=dev, optimizer=training.default_optimizer(
                warmup_steps=1, total_steps=10, learning_rate=1e-2))
        state = trainer.state_from_params(params)
        batch = training.synthetic_batch(2, 128, cfg.vocab_size, device=dev)
        losses[str(dev)] = []
        for _ in range(3):
            before = dict(tfa.flash_attention.launches)
            state, metrics = trainer.train_step(state, batch)
            losses[str(dev)].append(float(metrics["loss"]))
            launched = {n: tfa.flash_attention.launches[n] - before[n]
                        for n in before}
            want = 0 if str(dev) == "cpu" else cfg.num_layers
            assert launched == {"fwd": 2 * want, "dq": want, "dkv": want}
    np.testing.assert_allclose(losses[str(cuda_device)], losses["cpu"],
                               rtol=1e-4)
    assert losses["cpu"][2] < losses["cpu"][0]


def test_flash_use_kernel_on_cpu_raises():
    q, k, v, _ = _flash_case("cpu", torch.float32, 1, 128, 128, 4, 2, 128)
    with pytest.raises(RuntimeError, match="needs CUDA"):
        tfa.flash_attention(q, k, v, use_kernel=True)


@pytest.mark.gpu
def test_paged_kernel_rejects_what_it_does_not_take(cuda_device):
    args, kw = _paged_case(cuda_device, "bf16", 8, 2, 128, 64, (5,), 2)
    q, k, v, tables, pos = args
    with pytest.raises(ValueError, match="table entries"):
        tpda.paged_decode_attention(
            q, k, v, tables.repeat(1, tpda.MAX_TABLE_ENTRIES), pos)
    with pytest.raises(ValueError, match="d % 8"):
        tpda.paged_decode_attention(q[..., :100], k[..., :100].contiguous(),
                                    v[..., :100].contiguous(), tables, pos)
    with pytest.raises(ValueError, match="int8"):
        tpda.paged_decode_attention(q, k, v, tables, pos,
                                    k_scale=k[..., 0].float(),
                                    v_scale=v[..., 0].float())


def _dense_case(dev, kind, hq, hkv, d, s_max, positions, view, seed=0):
    """q and a dense cache [B, S_max, KVH, D] seen through ``view``:
    "contiguous"; "layer", the [1] view of an [L=2, B, S, KVH, D] cache
    (as the engine passes cache.k[li]); "slot", every other slot of a
    [2B, ...] cache (a batch stride twice the view's own); "head", every
    other kv head of a [B, S, 2 KVH, D] cache (a head stride of 2 D)."""
    rng = np.random.default_rng(seed)
    b = len(positions)
    shape = {"contiguous": (b, s_max, hkv, d), "layer": (2, b, s_max, hkv, d),
             "slot": (2 * b, s_max, hkv, d), "head": (b, s_max, 2 * hkv, d)}
    dt = {"bf16": torch.bfloat16, "fp32": torch.float32}[kind]
    k, v = (torch.from_numpy(rng.standard_normal(shape[view]).astype(
        np.float32)).to(dev, dt) for _ in range(2))
    pick = {"contiguous": lambda t: t, "layer": lambda t: t[1],
            "slot": lambda t: t[::2], "head": lambda t: t[:, :, ::2]}
    k, v = pick[view](k), pick[view](v)
    q = torch.from_numpy(rng.standard_normal((b, hq, d)).astype(
        np.float32)).to(dev, dt)
    return q, k, v, torch.tensor(positions, dtype=torch.int32, device=dev)


# (kind, hq, hkv, d, S_max, positions, view): the Llama-3-8B decode shape
# and its engine view, every group tile (G = 1, 2, 4, 8, and G = 3, 12,
# which split a kv head's group over blocks), D 64 and 128 (and 256 in
# fp32, which takes three warps a block), ragged S_max (no multiple of
# 64), positions 0, at tile edges, at S_max - 1 and past it, and strided
# views; S_max = 8192 (chunks of 512 tokens at B = 8); D = 8 in bf16 at
# group tile 8, where a warp's K rows (32 x 32 bytes) and its step's
# probabilities (32 x 8 fp32) take the same 1,024 bytes; and the external
# drafter's shape (D = 64, a layer view).
DENSE_CASES = {
    "llama3-bf16": ("bf16", 32, 8, 128, 2048,
                    (0, 63, 64, 700, 1023, 1500, 2047, 0), "contiguous"),
    "llama3-fp32": ("fp32", 32, 8, 128, 2048,
                    (0, 63, 64, 700, 1023, 1500, 2047, 0), "contiguous"),
    "llama3-layer-view-bf16": ("bf16", 32, 8, 128, 2048,
                               (5, 130, 2047, 999), "layer"),
    "g1-d64-fp32": ("fp32", 8, 8, 64, 256, (0, 127, 255), "contiguous"),
    "g2-ragged-bf16": ("bf16", 4, 2, 128, 1000, (63, 64, 999, 5000),
                       "contiguous"),
    "g3-bf16": ("bf16", 24, 8, 128, 300, (0, 100, 299), "contiguous"),
    "g8-d64-bf16": ("bf16", 64, 8, 64, 512, (1, 511, 300), "slot"),
    "g12-fp32": ("fp32", 48, 4, 128, 200, (64, 199), "head"),
    "g4-ragged-d64-fp32": ("fp32", 8, 2, 64, 77, (0, 76, 40), "layer"),
    "d256-fp32": ("fp32", 16, 4, 256, 130, (63, 129), "contiguous"),
    "long-bf16": ("bf16", 32, 8, 128, 8192,
                  (0, 63, 2047, 4095, 4096, 6000, 8191, 0), "contiguous"),
    "long-fp32": ("fp32", 32, 8, 128, 8192, (64, 8191, 3000), "layer"),
    "d8-g8-bf16": ("bf16", 16, 2, 8, 300, (0, 31, 32, 100, 299),
                   "contiguous"),
    # An external speculative drafter's step: Llama-3.2-1B's heads (D=64)
    # over a layer of its dense cache.
    "drafter-d64-bf16": ("bf16", 32, 8, 64, 2048,
                         (0, 63, 64, 700, 1023, 1500, 2047, 0), "layer"),
}


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(DENSE_CASES))
def test_dense_kernel_matches_plain(cuda_device, name):
    kind, hq, hkv, d, s_max, positions, view = DENSE_CASES[name]
    q, k, v, pos = _dense_case(cuda_device, kind, hq, hkv, d, s_max,
                               positions, view)
    before = tda.decode_attention.launches
    out = tda.decode_attention(q, k, v, pos)
    assert tda.decode_attention.launches == before + 1
    ref = tda.decode_attention(q, k, v, pos, use_kernel=False)
    assert tda.decode_attention.launches == before + 1
    torch.cuda.synchronize()
    assert out.dtype == ref.dtype and out.shape == ref.shape
    # fp32: the same math in another summation order. bf16 outputs: one
    # bf16 rounding (2^-8 relative) of nearly equal fp32 values.
    atol, rtol = (1e-5, 0.0) if out.dtype == torch.float32 else (2e-2, 2e-2)
    torch.testing.assert_close(out.float(), ref.float(), atol=atol,
                               rtol=rtol)


@pytest.mark.gpu
@pytest.mark.parametrize("sms", [1, 1024])
@pytest.mark.parametrize("name", ["llama3-bf16", "llama3-fp32",
                                  "g2-ragged-bf16", "long-bf16"])
def test_dense_kernel_few_and_many_splits(cuda_device, monkeypatch, name,
                                          sms):
    # The split count the host picks follows the SM count: one SM gives
    # one split (a block walks the whole cache), 1024 SMs a split a tile.
    kind, hq, hkv, d, s_max, positions, view = DENSE_CASES[name]
    monkeypatch.setattr(tda, "_num_sms", lambda index: sms)
    _, splits, chunk = tda.dense_layout(len(positions), hq, hkv, s_max, sms)
    assert (splits, chunk) == ((1, -(-s_max // 64) * 64) if sms == 1
                               else (-(-s_max // 64), 64))
    q, k, v, pos = _dense_case(cuda_device, kind, hq, hkv, d, s_max,
                               positions, view, seed=1)
    out = tda.decode_attention(q, k, v, pos)
    ref = tda.decode_attention(q, k, v, pos, use_kernel=False)
    torch.cuda.synchronize()
    atol, rtol = (1e-5, 0.0) if out.dtype == torch.float32 else (2e-2, 2e-2)
    torch.testing.assert_close(out.float(), ref.float(), atol=atol,
                               rtol=rtol)


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["bf16", "fp32"])
def test_dense_kernel_chunk_edges(cuda_device, kind):
    # Positions one before, on and one after the edges of the split
    # chunks the host picks for these shapes on this card.
    hq, hkv, d, s_max = 32, 8, 128, 2048
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    _, _, c = tda.dense_layout(6, hq, hkv, s_max, sms)
    positions = (c - 2, c - 1, c, 2 * c - 1, 2 * c, s_max - 1)
    q, k, v, pos = _dense_case(cuda_device, kind, hq, hkv, d, s_max,
                               positions, "layer", seed=3)
    out = tda.decode_attention(q, k, v, pos)
    ref = tda.decode_attention(q, k, v, pos, use_kernel=False)
    torch.cuda.synchronize()
    atol, rtol = (1e-5, 0.0) if out.dtype == torch.float32 else (2e-2, 2e-2)
    torch.testing.assert_close(out.float(), ref.float(), atol=atol,
                               rtol=rtol)


@pytest.mark.gpu
def test_dense_kernel_rejects_a_bad_layout(cuda_device, monkeypatch):
    # The C entry point checks the layout it is handed and refuses it
    # (cudaErrorInvalidValue); nothing falls back to the plain version.
    q, k, v, pos = _dense_case(cuda_device, "bf16", 32, 8, 128, 1000,
                               (5, 999), "contiguous")
    for bad in [(3, 1, 1024),      # a group tile that is not 1, 2, 4, 8
                (4, 2, 96),        # a chunk of no whole tiles
                (4, 2, 448),       # chunks that do not reach S_max
                (4, 3, 512)]:      # a split that starts past S_max
        monkeypatch.setattr(tda, "dense_layout", lambda *a, _b=bad: _b)
        before = tda.decode_attention.launches
        with pytest.raises(RuntimeError, match="launch failed"):
            tda.decode_attention(q, k, v, pos)
        assert tda.decode_attention.launches == before


@pytest.mark.gpu
def test_constructors_on_card_leave_bf16_reduction_flag(cuda_device):
    # bf16 GEMMs reduce in fp32 inside the engine's and the trainer's
    # steps only; the process's setting is what it was before and after.
    from ray_tpu_torch.models.continuous_batching import ContinuousBatcher

    matmul = torch.backends.cuda.matmul
    before = matmul.allow_bf16_reduced_precision_reduction
    try:
        matmul.allow_bf16_reduced_precision_reduction = True
        cfg = llama.LlamaConfig.tiny(
            dtype=torch.bfloat16, vocab_size=512, hidden_size=256,
            intermediate_size=512, num_heads=4, num_kv_heads=2,
            head_dim=128)
        eng = ContinuousBatcher(cfg, num_slots=2, max_len=128, paged=False,
                                device=cuda_device)
        trainer = training.ShardedTrainer(cfg, device=cuda_device)
        assert matmul.allow_bf16_reduced_precision_reduction is True
        eng.submit([1, 2, 3], max_new_tokens=2)
        eng.run_to_completion()
        state = trainer.init_state(0)
        trainer.train_step(state, training.synthetic_batch(
            2, 128, cfg.vocab_size, seed=0))
        assert matmul.allow_bf16_reduced_precision_reduction is True
    finally:
        matmul.allow_bf16_reduced_precision_reduction = before


@pytest.mark.gpu
def test_dense_kernel_q_and_cache_dtypes_may_differ(cuda_device):
    q, k, v, pos = _dense_case(cuda_device, "bf16", 16, 4, 128, 256,
                               (10, 255), "contiguous")
    out = tda.decode_attention(q.float(), k, v, pos)
    ref = tda.decode_attention_reference(q.float(), k, v, pos)
    torch.cuda.synchronize()
    assert out.dtype == torch.float32
    torch.testing.assert_close(out, ref, atol=1e-5, rtol=0.0)


@pytest.mark.gpu
def test_dense_kernel_rejects_what_it_does_not_take(cuda_device):
    q, k, v, pos = _dense_case(cuda_device, "bf16", 8, 2, 128, 64, (5,),
                               "contiguous")
    before = tda.decode_attention.launches
    with pytest.raises(ValueError, match="d % 8"):
        tda.decode_attention(q[..., :100], k[..., :100].contiguous(),
                             v[..., :100].contiguous(), pos)
    with pytest.raises(ValueError, match="cache dtype"):
        tda.decode_attention(q, k.to(torch.int8), v.to(torch.int8), pos)
    with pytest.raises(ValueError, match="cache dtype"):
        tda.decode_attention(q, k, v.float(), pos)
    with pytest.raises(ValueError, match="contiguous"):
        tda.decode_attention(q, k.transpose(2, 3).contiguous()
                             .transpose(2, 3), v.transpose(2, 3)
                             .contiguous().transpose(2, 3), pos)
    with pytest.raises(ValueError, match="strides"):
        tda.decode_attention(q, k, torch.cat([v, v], dim=2)[:, :, :2], pos)
    with pytest.raises(ValueError, match="aligned"):
        tda.decode_attention(q[..., :8], k[..., 4:12], v[..., 4:12], pos)
    with pytest.raises(ValueError, match="on"):
        tda.decode_attention(q, k, v, pos.cpu())
    assert tda.decode_attention.launches == before


@pytest.mark.gpu
def test_dense_engine_on_card_launches_kernel_and_matches_cpu(cuda_device):
    # A tiny fp32 dense engine on the card (the kernel) against the same
    # engine on the CPU (the plain version), greedy, from one set of
    # weights: num_layers launches per tick, the same tokens.
    from ray_tpu_torch.models.continuous_batching import ContinuousBatcher

    cfg = llama.LlamaConfig.tiny(dtype=torch.float32, head_dim=64)
    params = llama.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, size=n).tolist()
               for n in (5, 30, 70)]
    outs = {}
    for dev in ("cpu", cuda_device):
        dev_params = {k: ({n: t.to(dev) for n, t in v.items()}
                          if isinstance(v, dict) else v.to(dev))
                      for k, v in params.items()}
        eng = ContinuousBatcher(cfg, params=dev_params, num_slots=2,
                                max_len=128, paged=False, device=dev)
        before = tda.decode_attention.launches
        rids = [eng.submit(p, max_new_tokens=8) for p in prompts]
        done = eng.run_to_completion()
        launched = tda.decode_attention.launches - before
        want = 0 if str(dev) == "cpu" else cfg.num_layers * \
            eng.base_tick_count
        assert launched == want
        outs[str(dev)] = [done[r] for r in rids]
    assert outs[str(cuda_device)] == outs["cpu"]


def _tiny_on(dev, dtype=torch.float32, head_dim=64, seed=0, **kw):
    """A tiny config and its weights, drawn on the CPU and copied to
    ``dev`` (so a CPU engine and a card engine share them)."""
    cfg = llama.LlamaConfig.tiny(dtype=dtype, head_dim=head_dim, **kw)
    params = llama.init_params(cfg, torch.Generator().manual_seed(seed),
                               "cpu")
    return cfg, {k: ({n: t.to(dev) for n, t in v.items()}
                     if isinstance(v, dict) else v.to(dev))
                 for k, v in params.items()}


@pytest.mark.gpu
@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
def test_prefix_cache_on_card_matches_off(cuda_device, kv_dtype):
    # The paged kernel over tables whose leading entries are shared,
    # read-only prefix blocks: greedy tokens with the prefix cache on
    # equal those with it off, num_layers launches a tick, and the
    # followers prefill only their suffixes.
    from ray_tpu_torch.models.continuous_batching import ContinuousBatcher

    cfg, params = _tiny_on(cuda_device)
    rng = np.random.default_rng(0)
    shared = rng.integers(0, cfg.vocab_size, size=40).tolist()
    prompts = [shared + rng.integers(0, cfg.vocab_size, size=n).tolist()
               for n in (3, 9, 1)]
    outs = {}
    for on in (True, False):
        eng = ContinuousBatcher(cfg, params=params, num_slots=2,
                                max_len=128, block_size=16,
                                kv_dtype=kv_dtype, prefix_cache=on,
                                device=cuda_device)
        before = tpda.paged_decode_attention.launches
        got = []
        for p in prompts:                 # sequential: real reuse
            rid = eng.submit(p, max_new_tokens=8)
            got.append(eng.run_to_completion()[rid])
        assert tpda.paged_decode_attention.launches - before == \
            cfg.num_layers * eng.base_tick_count
        assert eng.prefix_hit_tokens == (2 * 2 * 16 if on else 0)
        outs[on] = got
    assert outs[True] == outs[False]


@pytest.mark.gpu
@pytest.mark.parametrize("paged", [True, False], ids=["paged", "dense"])
def test_buffered_on_card_matches_per_tick(cuda_device, paged):
    # sync_every=4 fetches tokens through a pinned host tensor copied
    # without blocking; greedy tokens equal sync_every=1's, and every tick
    # launches the engine's decode kernel num_layers times.
    from ray_tpu_torch.models.continuous_batching import ContinuousBatcher

    cfg, params = _tiny_on(cuda_device)
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, cfg.vocab_size, size=n).tolist()
               for n in (5, 30, 12)]
    counter = (tpda.paged_decode_attention if paged
               else tda.decode_attention)
    outs = {}
    for k in (1, 4):
        eng = ContinuousBatcher(cfg, params=params, num_slots=2,
                                max_len=128, block_size=16, paged=paged,
                                sync_every=k, device=cuda_device)
        before = counter.launches
        rids = [eng.submit(p, max_new_tokens=n)
                for p, n in zip(prompts, (9, 14, 6))]
        pinned = False
        done = {}
        while eng.has_work():
            done.update(eng.step())
            if eng._pending is not None:
                pinned |= eng._pending[0][0].is_pinned()
        assert counter.launches - before == \
            cfg.num_layers * eng.base_tick_count
        assert pinned == (k > 1)
        outs[k] = [done[r] for r in rids]
    assert outs[4] == outs[1]


def _masked_attention(q, k, v, keep):
    """Plain GQA attention of q [B, S, Hq, D] over k, v [B, S, KVH, D] in
    fp32, where ``keep`` [S, S] says which keys each query sees."""
    g = q.shape[2] // k.shape[2]
    kf, vf = (t.float().repeat_interleave(g, dim=2) for t in (k, v))
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), kf) * q.shape[3] ** -0.5
    p = torch.softmax(s.masked_fill(~keep, float("-inf")), dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, vf).to(q.dtype)


@pytest.mark.gpu
def test_score_logprobs_flash_kernel_matches_plain(cuda_device,
                                                   monkeypatch):
    # score_logprobs' forward runs the bf16 flash forward kernel (D=128,
    # one launch a layer) and agrees with attention_kernel=False at the
    # bf16 flash tolerance. Random weights put every logprob near
    # -log(vocab), so that alone cannot fail: each launch is also held
    # against the plain forward on the q/k/v scoring gave it, where three
    # wrong attentions (no causal mask, each row's own 64-key block
    # skipped, zeros) must each fall outside the tolerance.
    import dataclasses

    from ray_tpu_torch.models.continuous_batching import ContinuousBatcher

    cfg, params = _tiny_on(cuda_device, dtype=torch.bfloat16, head_dim=128,
                           vocab_size=512, hidden_size=256,
                           intermediate_size=512)
    rng = np.random.default_rng(2)
    prompt = rng.integers(0, cfg.vocab_size, size=40).tolist()
    out = rng.integers(0, cfg.vocab_size, size=50).tolist()
    inner = llama.flash_attention
    calls = []

    def record(q, k, v, **kw):
        o = inner(q, k, v, **kw)
        calls.append((q, k, v, kw, o))
        return o

    got = {}
    for kernel in (None, False):
        eng = ContinuousBatcher(
            dataclasses.replace(cfg, attention_kernel=kernel),
            params=params, num_slots=2, max_len=128, device=cuda_device)
        before = tfa.flash_attention.launches["fwd"]
        with monkeypatch.context() as mp:
            if kernel is None:
                mp.setattr(llama, "flash_attention", record)
            got[kernel] = eng.score_logprobs(prompt, out)
        launched = tfa.flash_attention.launches["fwd"] - before
        assert launched == (cfg.num_layers if kernel is None else 0)
    atol, rtol = _flash_tol(torch.bfloat16)
    np.testing.assert_allclose(got[None], got[False], atol=atol, rtol=rtol)
    assert got[None].shape == (50,) and np.all(np.isfinite(got[None]))

    assert len(calls) == cfg.num_layers
    for q, k, v, kw, o in calls:
        assert kw["causal"] and q.shape[:2] == (1, 128)
        want, _ = tfa.flash_fwd_reference(q, k, v, scale=128 ** -0.5,
                                          causal=True)
        torch.testing.assert_close(o.float(), want.float(), atol=atol,
                                   rtol=rtol)
    q, k, v, _, _ = calls[0]
    want, _ = tfa.flash_fwd_reference(q, k, v, scale=128 ** -0.5,
                                      causal=True)
    rows = torch.arange(128, device=cuda_device)[:, None]
    cols = torch.arange(128, device=cuda_device)[None, :]
    causal = cols <= rows
    for wrong in (_masked_attention(q, k, v, torch.ones_like(causal)),
                  _masked_attention(q, k, v, (cols < rows // 64 * 64)
                                    | (causal & (rows < 64))),
                  torch.zeros_like(want)):
        err = (wrong.float() - want.float()).abs()
        assert bool((err > atol + rtol * want.float().abs()).any())


def _spec_requests(cfg, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab_size, size=n).tolist()
            for n in (5, 30, 12)]


def _serve(eng, prompts, max_new=(9, 14, 6)):
    rids = [eng.submit(p, max_new_tokens=n) for p, n in zip(prompts,
                                                            max_new)]
    done = eng.run_to_completion()
    return [done[r] for r in rids]


@pytest.mark.gpu
@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
def test_spec_on_card_matches_off(cuda_device, kv_dtype):
    # fp32 self-draft spec decode on the card (k=2, one draft layer):
    # greedy tokens equal spec-off's, and the paged kernel launches
    # n_draft a draft step and num_layers a verify position, the dense
    # kernel never.
    from ray_tpu_torch.models.continuous_batching import ContinuousBatcher

    cfg, params = _tiny_on(cuda_device)
    prompts = _spec_requests(cfg, 3)
    outs = {}
    for k in (0, 2):
        eng = ContinuousBatcher(cfg, params=params, num_slots=2,
                                max_len=128, block_size=16,
                                kv_dtype=kv_dtype, spec_k=k,
                                spec_draft_layers=1, spec_adaptive=False,
                                device=cuda_device)
        paged0 = tpda.paged_decode_attention.launches
        dense0 = tda.decode_attention.launches
        outs[k] = _serve(eng, prompts)
        L = cfg.num_layers
        assert tpda.paged_decode_attention.launches - paged0 == (
            L * eng.base_tick_count
            + eng.spec_tick_count * (k * 1 + (k + 1) * L))
        assert tda.decode_attention.launches == dense0
        assert (eng.spec_tick_count > 0) == (k > 0)
    assert outs[2] == outs[0]


@pytest.mark.gpu
def test_spec_external_drafter_on_card_runs_dense_kernel(cuda_device):
    # An external drafter (the target's own weights, so it accepts) on the
    # card: tokens equal spec-off's; verify launches the paged kernel
    # num_layers a window position, the drafter the dense kernel its
    # num_layers a draft step.
    from ray_tpu_torch.models.continuous_batching import ContinuousBatcher
    from ray_tpu_torch.models.inference import ExternalLlamaDrafter

    cfg, params = _tiny_on(cuda_device)
    prompts = _spec_requests(cfg, 4)
    base = _serve(ContinuousBatcher(cfg, params=params, num_slots=2,
                                    max_len=128, block_size=16,
                                    device=cuda_device), prompts)
    k = 3
    eng = ContinuousBatcher(cfg, params=params, num_slots=2, max_len=128,
                            block_size=16, spec_k=k, spec_adaptive=False,
                            drafter=ExternalLlamaDrafter(cfg, params=params),
                            device=cuda_device)
    paged0 = tpda.paged_decode_attention.launches
    dense0 = tda.decode_attention.launches
    assert _serve(eng, prompts) == base
    L = cfg.num_layers
    assert eng.spec_tick_count > 0 and eng.spec_accept_rate > 0.2
    assert tpda.paged_decode_attention.launches - paged0 == (
        L * eng.base_tick_count + eng.spec_tick_count * (k + 1) * L)
    assert tda.decode_attention.launches - dense0 == \
        eng.spec_tick_count * k * L


@pytest.mark.gpu
def test_sampled_spec_on_card_deterministic(cuda_device):
    # Sampled spec decode draws from generators on the card: the same seed
    # gives the same tokens at sync_every 1 and 4 (every request admitted
    # up front; rewinds replay their steps), another seed others; the
    # buffered fetch is pinned.
    from ray_tpu_torch.models.continuous_batching import ContinuousBatcher

    cfg, params = _tiny_on(cuda_device)
    prompts = _spec_requests(cfg, 5)
    got = {}
    for sync_every, seed in ((1, 11), (4, 11), (4, 11), (4, 12)):
        eng = ContinuousBatcher(
            cfg, params=params, num_slots=4, max_len=128, block_size=16,
            spec_k=2, spec_draft_layers=1, spec_adaptive=False,
            sync_every=sync_every, device=cuda_device,
            sampling=dict(temperature=0.8, top_p=0.9, seed=seed))
        rids = [eng.submit(p, max_new_tokens=n)
                for p, n in zip(prompts, (9, 14, 6))]
        pinned, done = [], {}
        while eng.has_work():
            done.update(eng.step())
            if eng._pending is not None:
                pinned += [h.is_pinned() for h in eng._pending[0][0]]
        assert eng.spec_tick_count > 0
        assert (all(pinned) and len(pinned) > 0) == (sync_every > 1)
        got.setdefault((sync_every, seed), []).append(
            [done[r] for r in rids])
    assert got[(4, 11)][0] == got[(4, 11)][1] == got[(1, 11)][0]
    assert got[(4, 12)][0] != got[(4, 11)][0]


def _split_serve(pre, dec, prompts, max_new=(9, 14, 6)):
    """The router's drive over a prefill-role and a decode-role engine:
    reserve, submit, then rounds of a prefill step, the transfer of every
    parked request the decode engine has a slot for, and a decode step.
    Returns the decode engine's outputs in submit order."""
    from ray_tpu_torch.serve import kv_transfer

    tickets = {}
    for p, n in zip(prompts, max_new):
        ticket = dec.reserve_import(len(p), n)
        tickets[pre.submit(p, max_new_tokens=n)] = ticket
    local, out = {}, {}
    while pre.has_work() or dec.has_work() or pre.handoff_ready():
        pre.step()
        for rid in pre.handoff_ready():
            if dec.active_count >= dec.num_slots:
                break
            local[rid] = kv_transfer.transfer_inproc(
                pre, dec, rid, reservation=tickets.pop(rid))
        out.update(dec.step())
    return [out[local[r]] for r in sorted(local)]


@pytest.mark.gpu
@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
def test_split_on_card_matches_colocated(cuda_device, kv_dtype):
    # fp32 prefill/decode split on the card: the decode engine's tokens
    # equal the colocated engine's; every paged launch is the decode
    # engine's (num_layers a tick), the prefill engine never ticks; with 2
    # decode slots the third import waits for a slot and lands mid-flight.
    from ray_tpu_torch.models.continuous_batching import ContinuousBatcher

    cfg, params = _tiny_on(cuda_device)
    prompts = _spec_requests(cfg, 6)
    kw = dict(params=params, num_slots=2, max_len=128, block_size=16,
              kv_dtype=kv_dtype, device=cuda_device)
    base = _serve(ContinuousBatcher(cfg, **kw), prompts)
    pre = ContinuousBatcher(cfg, role="prefill", **kw)
    dec = ContinuousBatcher(cfg, role="decode", **kw)
    before = tpda.paged_decode_attention.launches
    assert _split_serve(pre, dec, prompts) == base
    assert pre.base_tick_count == pre.spec_tick_count == 0
    assert tpda.paged_decode_attention.launches - before == \
        cfg.num_layers * dec.base_tick_count
    assert pre.handoff_exports == dec.handoff_imports == 3
    assert dec.pressure_snapshot()["import_reservations"] == 0


@pytest.mark.gpu
@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
def test_staging_crc_reads_landed_bytes(cuda_device, kv_dtype):
    # The arena is refilled on the card right before each gather, so a crc
    # taken before the device-to-host copy landed would read stale or
    # half-written bytes: 20 round trips, each staging buffer equal to the
    # blocks' bytes read back after a full synchronize, its crc that of
    # those bytes, and the scatter into another arena on the card equal.
    import zlib

    from ray_tpu_torch.models.paged_kv import PagedKVCache

    cfg = llama.LlamaConfig.tiny(dtype=torch.bfloat16, num_layers=4,
                                 num_kv_heads=8, num_heads=8, head_dim=128)
    src = PagedKVCache.create(cfg, 64, 64, kv_dtype, device=cuda_device)
    dst = PagedKVCache.create(cfg, 64, 64, kv_dtype, device=cuda_device)
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    blocks = list(range(1, 64))
    for i in range(20):
        for _, arr in src._parts():
            fresh = torch.randn(arr.shape, generator=gen,
                                device=cuda_device) * 50
            arr.copy_(fresh.to(arr.dtype))
        staging, layout = src.gather_blocks(blocks)
        crc = zlib.crc32(staging)
        torch.cuda.synchronize()
        want = torch.cat([arr[:, blocks].reshape(-1).view(torch.uint8)
                          for _, arr in src._parts()]).cpu().numpy()
        assert staging.tobytes() == want.tobytes(), i
        assert crc == zlib.crc32(want), i
        order = blocks[i:] + blocks[:i]
        dst.scatter_blocks(order, staging, layout)
        for (_, a), (_, b) in zip(src._parts(), dst._parts()):
            assert torch.equal(a[:, blocks], b[:, order]), i


@pytest.mark.gpu
def test_card_payload_decodes_on_cpu(cuda_device):
    # A payload exported on the card (pinned staging) and imported by a
    # device="cpu" decode engine gives the card's colocated tokens and the
    # CPU's.
    from ray_tpu_torch.models.continuous_batching import ContinuousBatcher
    from ray_tpu_torch.serve import kv_transfer

    cfg, params = _tiny_on(cuda_device)
    _, cpu_params = _tiny_on("cpu")
    prompts = _spec_requests(cfg, 7)
    kw = dict(num_slots=4, max_len=128, block_size=16)
    want = _serve(ContinuousBatcher(cfg, params=params, device=cuda_device,
                                    **kw), prompts)
    assert _serve(ContinuousBatcher(cfg, params=cpu_params, device="cpu",
                                    **kw), prompts) == want
    pre = ContinuousBatcher(cfg, params=params, role="prefill",
                            device=cuda_device, **kw)
    dec = ContinuousBatcher(cfg, params=cpu_params, role="decode",
                            device="cpu", **kw)
    rids = [pre.submit(p, max_new_tokens=n)
            for p, n in zip(prompts, (9, 14, 6))]
    pre.run_to_completion()
    payloads = [kv_transfer.export_kv(pre, r) for r in rids]
    assert all(p["staging"].base.is_pinned() for p in payloads)
    local = [kv_transfer.import_kv(dec, p) for p in payloads]
    out = dec.run_to_completion()
    assert [out[r] for r in local] == want


# -- the Mixtral family ------------------------------------------------------

def _moe_case(x_dim=32, m=48, experts=4, tied=False, seed=0):
    p = moe.init_moe_params(x_dim, m, experts, dtype=torch.float32,
                            generator=torch.Generator().manual_seed(seed),
                            device="cpu")
    if tied:                       # a router at zero ties every expert
        p["w_router"] = torch.zeros_like(p["w_router"])
    x = torch.randn((2, 64, x_dim),
                    generator=torch.Generator().manual_seed(seed + 1))
    return x, p


@pytest.mark.gpu
def test_router_topk_ties_go_to_the_lower_index_on_card(cuda_device):
    rng = np.random.default_rng(0)
    for logits in (np.zeros((4096, 8), np.float32),
                   rng.integers(-2, 3, (4096, 8)).astype(np.float32)):
        cpu_w, cpu_i = moe.router_topk(torch.from_numpy(logits), 2)
        w, i = moe.router_topk(torch.from_numpy(logits).to(cuda_device), 2)
        # The CPU order is JAX's (tests/test_torch_moe.py).
        assert torch.equal(i.cpu(), cpu_i)
        torch.testing.assert_close(w.cpu(), cpu_w, atol=1e-7, rtol=0)
    zeros = moe.router_topk(torch.zeros((16, 8), device=cuda_device), 2)[1]
    assert torch.equal(zeros.cpu(), torch.tensor([[0, 1]] * 16))


@pytest.mark.gpu
@pytest.mark.parametrize("tied,cf", [(False, 1.25), (False, 0.5),
                                     (True, 1.25)])
def test_moe_layer_on_card_matches_cpu(cuda_device, tied, cf):
    # fp32 (no TF32): the same routing, drops and slots; the products sum
    # in another order, within 1e-5 of the largest entry.
    x, p = _moe_case(tied=tied)
    kw = dict(num_experts=4, top_k=2, capacity_factor=cf)
    want, waux = moe.moe_layer(x, p, **kw)
    got, aux = moe.moe_layer(x.to(cuda_device),
                             {k: v.to(cuda_device) for k, v in p.items()},
                             **kw)
    torch.cuda.synchronize()
    assert got.device.type == "cuda" and got.shape == want.shape
    assert float(aux["dropped_fraction"]) == float(waux["dropped_fraction"])
    if tied or cf < 1:
        assert float(waux["dropped_fraction"]) > 0
    torch.testing.assert_close(got.cpu(), want, rtol=0,
                               atol=1e-5 * float(want.abs().max()))
    torch.testing.assert_close(aux["aux_loss"].cpu(), waux["aux_loss"],
                               rtol=1e-6, atol=0)


@pytest.mark.gpu
def test_mixtral_loss_flash_kernels_match_plain(cuda_device):
    # chip_smoke phase 9's limits: loss within 1e-5 relative, each grad
    # leaf within 1e-4 of its largest entry (fp32 attention in another
    # summation order, carried through two layers and the routing).
    import dataclasses

    cfg = mixtral.MixtralConfig.tiny(
        dtype=torch.float32, vocab_size=512, hidden_size=256,
        intermediate_size=256, num_heads=4, num_kv_heads=2, head_dim=128)
    params = mixtral.init_params(cfg, torch.Generator(
        device=cuda_device).manual_seed(0), device=cuda_device)
    leaves = [p.requires_grad_(True) for v in params.values()
              for p in (v.values() if isinstance(v, dict) else [v])]
    tokens = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (1, 256)).astype(np.int32)).to(cuda_device)
    got = {}
    for kernel in (None, False):
        before = dict(tfa.flash_attention.launches)
        loss, m = mixtral.loss_fn(params, {"tokens": tokens},
                                  dataclasses.replace(
                                      cfg, attention_kernel=kernel))
        grads = torch.autograd.grad(loss, leaves)
        torch.cuda.synchronize()
        launched = {n: tfa.flash_attention.launches[n] - before[n]
                    for n in before}
        L = cfg.num_layers
        assert launched == ({"fwd": L, "dq": L, "dkv": L} if kernel is None
                            else {"fwd": 0, "dq": 0, "dkv": 0})
        assert float(m["aux_loss"].detach()) > 0
        got[kernel] = (float(loss.detach()), grads)
    (l1, g1), (l0, g0) = got[None], got[False]
    assert abs(l1 - l0) <= 1e-5 * abs(l0)
    for a, b in zip(g1, g0):
        assert float((a - b).abs().max()) <= 1e-4 * float(b.abs().max())

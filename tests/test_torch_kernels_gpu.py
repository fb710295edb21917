"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Every test here is marked ``gpu`` and skips without a CUDA device.
The file imports neither JAX nor ``ray_tpu``, so it also runs on a
machine that has only PyTorch:

    python -m pytest --noconftest -m gpu tests/test_torch_kernels_gpu.py
"""

import numpy as np
import pytest
import torch

from ray_tpu_torch.models import llama, training
from ray_tpu_torch.models.paged_kv import GARBAGE_BLOCK, quantize_kv
from ray_tpu_torch.ops import attention as tfa
from ray_tpu_torch.ops import decode_attention as tda
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
# fp32, which takes one smem stage), ragged S_max (no multiple of 64),
# positions 0, at tile edges, at S_max - 1 and past it, and strided views.
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

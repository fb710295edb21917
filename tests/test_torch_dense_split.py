"""The split-K (flash-decoding) arithmetic of the dense decode kernel,
emulated on the CPU.

``ray_tpu_torch/ops/csrc/decode_attention.cu`` cuts each slot's tokens
into ``splits`` chunks of whole 64-token tiles. One block per (slot, group
tile of query heads, chunk) walks a chunk: each of its warps (4, or 2 for
a 64-token chunk) takes 32-token steps (w, w + warps, ...) with its own
fp32 online softmax, reading token t of kv head h at element ``b*kv_sb +
t*kv_st + h*kv_sh`` of the cache's storage, and never a row at or past
``min(pos + 1, S_max)``. The warps merge once into the block's
unnormalised partial (acc, max, sum per query head), and the combine
kernel (``csrc/split_combine.cuh``) rescales a row's live partials: ``out
= sum_i acc_i e^(m_i - M) / sum_i l_i e^(m_i - M)`` with ``l == 0 -> 1``.
Blocks whose chunk lies past ``pos`` write nothing, and the combine reads
only the live ones. Here plain PyTorch repeats those steps, and the result
is held to ``decode_attention_reference`` and to the JAX package's
``decode_attention(use_kernel=True)`` (the Pallas ``_decode_kernel``) in
interpret mode. The layout (group tile, split count, chunk) is chosen on
the host from shapes alone (:func:`dense_layout`), never from
``positions``, and passed to the kernel.
"""

import contextlib
import importlib
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu_torch.ops import _split
from ray_tpu_torch.ops import decode_attention as tda

# ``ray_tpu.ops`` re-exports the function under the module's name.
jda = importlib.import_module("ray_tpu.ops.decode_attention")

WARPS, STEP = 4, 32            # the kernel's warps a block, tokens a step
HQ, HKV, D, S_MAX = 4, 2, 32, 1000          # 16 tiles, the last ragged
# Positions one before and on the edges of tiles (every chunk edge is a
# tile edge), S_max - 2 and - 1 (the ragged last tile), past S_max, and
# a freed slot (pos 0).
POSITIONS = (0, 62, 63, 64, 127, 128, 191, 192, 255, 256, 511, 512, 767,
             998, 999, 5000, 0)
TILES = -(-S_MAX // _split.SPLIT_TILE)
SPLIT_COUNTS = tuple(range(1, TILES + 1)) + (TILES + 2,)   # + dead splits
# fp32: the same math in another summation order. bf16: the same bf16
# inputs and fp32 math; the outputs differ by one bf16 rounding.
TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}

_jax_out = {}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _inputs(positions=POSITIONS, hq=HQ, hkv=HKV, d=D, s_max=S_MAX,
            seed=0):
    """numpy fp32 q [B, Hq, D], cache K/V [B, S_max, KVH, D] and int32
    positions."""
    rng = np.random.default_rng(seed)
    b = len(positions)
    q = rng.standard_normal((b, hq, d)).astype(np.float32)
    k = rng.standard_normal((b, s_max, hkv, d)).astype(np.float32)
    v = rng.standard_normal((b, s_max, hkv, d)).astype(np.float32)
    return q, k, v, np.asarray(positions, np.int32)


def _view(a, view):
    """The cache ``a`` [B, S, KVH, D] as a strided view, the way the
    engine or a caller hands it in: "layer", the [1] view of an [L=2, B,
    S, KVH, D] cache (cache.k[li]); "slot", every other slot of a [2B, ...]
    cache; "head", every other kv head of a [B, S, 2 KVH, D] cache."""
    t = torch.from_numpy(a)
    if view == "contiguous":
        return t
    if view == "layer":
        big = torch.stack([torch.full_like(t, float("nan")), t])
        return big[1]
    if view == "slot":
        big = torch.full((2 * t.shape[0],) + t.shape[1:], float("nan"))
        big[::2] = t
        return big[::2]
    big = torch.full(t.shape[:2] + (2 * t.shape[2], t.shape[3]),
                     float("nan"))
    big[:, :, ::2] = t
    return big[:, :, ::2]


def _rows(cache, b, toks, h):
    """Rows ``cache[b, toks, h, :]`` fetched as the kernel addresses them:
    element ``b*kv_sb + t*kv_st + h*kv_sh`` (plus the view's offset) of
    the cache's storage, in the cache's dtype."""
    numel = cache.untyped_storage().nbytes() // cache.element_size()
    flat = torch.as_strided(cache, (numel,), (1,), 0)
    sb, st, sh, _ = cache.stride()
    off = (cache.storage_offset() + b * sb + toks[:, None] * st + h * sh
           + torch.arange(cache.shape[3])[None, :])
    assert int(off.max()) < numel
    return flat[off]


def _weight(m, big_m):
    """e^(m - M); an empty partial (m = -inf) weighs exactly 0."""
    return torch.where(m == -torch.inf, torch.zeros_like(m),
                       torch.exp(m - big_m))


def emulate_split_kernel(q, cache_k, cache_v, positions, scale, gt, splits,
                         chunk):
    """(out in q's dtype, ws_acc [B, Hq, splits, D], ws_ml [B, Hq, splits,
    2], loaded) as the split and combine kernels compute them, for the
    layout (gt, splits, chunk). Workspace entries no block writes stay
    NaN, so reading one would show in ``out``; ``loaded`` maps (slot, kv
    head) to the largest token a block copied."""
    b_, hq, d = q.shape
    s_max, hkv = cache_k.shape[1], cache_k.shape[2]
    group = hq // hkv
    assert group % gt == 0 and chunk % _split.SPLIT_TILE == 0
    warps = min(WARPS, chunk // STEP)
    ws_acc = torch.full((b_, hq, splits, d), torch.nan)
    ws_ml = torch.full((b_, hq, splits, 2), torch.nan)
    n_toks = [0 if p < 0 else min(int(p) + 1, s_max) for p in positions]
    loaded = {}
    for b, n_tok in enumerate(n_toks):
        for blk in range(hkv * (group // gt)):
            h = blk // (group // gt)
            heads = slice(h * group + blk % (group // gt) * gt,
                          h * group + blk % (group // gt) * gt + gt)
            qg = q[b, heads].float()                     # [GT, D]
            for i in range(splits):
                c0, c1 = i * chunk, min((i + 1) * chunk, n_tok)
                if c0 >= n_tok:
                    continue             # the block exits at once
                parts = []
                for w in range(warps):
                    m = torch.full((gt,), -torch.inf)
                    l = torch.zeros(gt)
                    acc = torch.zeros(gt, d)
                    for t0 in range(c0 + w * STEP, c1, warps * STEP):
                        toks = torch.arange(t0, min(t0 + STEP, c1))
                        loaded[b, h] = max(loaded.get((b, h), -1),
                                           int(toks[-1]))
                        k = _rows(cache_k, b, toks, h).float()
                        v = _rows(cache_v, b, toks, h).float()
                        s = (qg @ k.T) * scale                 # [GT, T]
                        m_new = torch.maximum(m, s.amax(dim=1))
                        alpha = torch.exp(m - m_new)
                        e = torch.exp(s - m_new[:, None])
                        l = alpha * l + e.sum(dim=1)
                        m = m_new
                        acc = acc * alpha[:, None] + e @ v
                    parts.append((m, l, acc))
                big_m = torch.stack([pm for pm, _, _ in parts]).amax(dim=0)
                ws_acc[b, heads, i] = sum(pa * _weight(pm, big_m)[:, None]
                                          for pm, _, pa in parts)
                ws_ml[b, heads, i, 0] = big_m
                ws_ml[b, heads, i, 1] = sum(pl * _weight(pm, big_m)
                                            for pm, pl, _ in parts)
    out = torch.zeros(b_, hq, d)
    for b, n_tok in enumerate(n_toks):
        live = -(-n_tok // chunk)
        if live == 0:
            continue
        m, l = ws_ml[b, :, :live, 0], ws_ml[b, :, :live, 1]
        w = _weight(m, m.amax(dim=1, keepdim=True))
        big_l = (l * w).sum(dim=1)
        big_l = torch.where(big_l == 0, torch.ones_like(big_l), big_l)
        out[b] = (ws_acc[b, :, :live] * w[..., None]).sum(dim=1) / \
            big_l[:, None]
    return out.to(q.dtype), ws_acc, ws_ml, loaded


def _jax_interpret(name, q, k, v, pos, dtype=torch.float32, block_k=200):
    """The JAX package's Pallas ``_decode_kernel`` in interpret mode, once
    per input set."""
    if name not in _jax_out:
        jt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
        _jax_out[name] = np.asarray(jda.decode_attention(
            *(jnp.asarray(a, jt) for a in (q, k, v)), jnp.asarray(pos),
            use_kernel=True, block_k=block_k).astype(jnp.float32))
    return _jax_out[name]


def _check(got, ref, want, dtype):
    tol = TOL[dtype]
    assert got.dtype == dtype and torch.isfinite(got.float()).all()
    np.testing.assert_allclose(got.float().numpy(), ref.float().numpy(),
                               atol=tol, rtol=tol if tol > 1e-5 else 0)
    np.testing.assert_allclose(got.float().numpy(), want, atol=tol,
                               rtol=tol if tol > 1e-5 else 0)


@pytest.mark.parametrize("splits", SPLIT_COUNTS)
def test_split_emulation_matches_plain_and_jax(pallas_interpret, splits):
    q, k, v, pos = _inputs()
    scale = D ** -0.5
    t = [torch.from_numpy(a) for a in (q, k, v, pos)]
    chunk = _split.chunk_tokens(S_MAX, splits)
    gt = _split.group_tile(HQ // HKV)
    got, ws_acc, ws_ml, loaded = emulate_split_kernel(*t, scale, gt, splits,
                                                      chunk)
    ref = tda.decode_attention_reference(*t, scale)
    _check(got, ref, _jax_interpret("fp32", q, k, v, pos), torch.float32)
    # Chunks wholly past pos are never written (the block exits) and so
    # never read; no row at or past min(pos + 1, S_max) is loaded.
    for b, p in enumerate(POSITIONS):
        n_tok = min(p + 1, S_MAX)
        live = -(-n_tok // chunk)
        assert torch.isfinite(ws_ml[b, :, :live]).all()
        assert torch.isnan(ws_ml[b, :, live:]).all()
        assert torch.isnan(ws_acc[b, :, live:]).all()
        assert all(loaded[b, h] == n_tok - 1 for h in range(HKV))


@pytest.mark.parametrize("splits", [1, 3, TILES])
def test_split_emulation_bf16_within_bf16_tolerance(pallas_interpret,
                                                    splits):
    q, k, v, pos = _inputs(seed=1)
    t = [torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v)]
    p = torch.from_numpy(pos)
    got, _, _, _ = emulate_split_kernel(
        *t, p, D ** -0.5, _split.group_tile(HQ // HKV), splits,
        _split.chunk_tokens(S_MAX, splits))
    ref = tda.decode_attention_reference(*t, p, D ** -0.5)
    assert ref.dtype == torch.bfloat16
    _check(got, ref, _jax_interpret("bf16", q, k, v, pos, torch.bfloat16),
           torch.bfloat16)


# (G, view, S_max, positions): every group tile (G = 1, 2, 4, 8, and 3,
# 12, whose groups a block cuts into tiles of 1 and 4), ragged S_max (77:
# one ragged tile; 1000), strided layer, slot and head views; positions
# at 0, tile edges, S_max - 1 and past it.
GROUP_CASES = {
    "g1-contiguous-77": (1, "contiguous", 77, (0, 63, 64, 76, 300)),
    "g2-layer-1000": (2, "layer", 1000, (5, 127, 128, 999, 4000)),
    "g3-slot-77": (3, "slot", 77, (1, 64, 76)),
    "g4-head-1000": (4, "head", 1000, (0, 255, 256, 640, 999)),
    "g8-layer-77": (8, "layer", 77, (40, 63, 76, 77)),
    "g12-slot-200": (12, "slot", 200, (0, 100, 199)),
}


@pytest.mark.parametrize("name", sorted(GROUP_CASES))
def test_group_tiles_and_strided_views(pallas_interpret, name):
    g, view, s_max, positions = GROUP_CASES[name]
    hkv, d = 2, 16
    q, k, v, pos = _inputs(positions, hq=g * hkv, hkv=hkv, d=d,
                           s_max=s_max, seed=3)
    tq, tp = torch.from_numpy(q), torch.from_numpy(pos)
    tk, tv = _view(k, view), _view(v, view)
    # A view past its storage's start, or with strides of its own.
    assert view == "contiguous" or tk.storage_offset() or \
        not tk.is_contiguous()
    ref = tda.decode_attention_reference(tq, tk, tv, tp)
    want = _jax_interpret(name, q, k, v, pos, block_k=s_max)
    gt = _split.group_tile(g)
    assert g % gt == 0 and gt == {1: 1, 2: 2, 3: 1, 4: 4, 8: 8, 12: 4}[g]
    tiles = -(-s_max // _split.SPLIT_TILE)
    layouts = {tda.dense_layout(len(positions), g * hkv, hkv, s_max, sms)
               for sms in (1, 132, 1024)}
    layouts |= {(gt, n, _split.chunk_tokens(s_max, n)) for n in (1, tiles)}
    for lgt, splits, chunk in sorted(layouts):
        got, _, _, _ = emulate_split_kernel(tq, tk, tv, tp, d ** -0.5, lgt,
                                            splits, chunk)
        _check(got, ref, want, torch.float32)


def test_negative_position_gives_zeros_as_the_pallas_kernel(
        pallas_interpret):
    # pos < 0: no live token, no block writes, the combine reads nothing
    # and writes 0 / 1, as the TPU kernel runs no block and divides by 1.
    q, k, v, pos = _inputs((-1, 5), s_max=128)
    t = [torch.from_numpy(a) for a in (q, k, v, pos)]
    got, _, ws_ml, _ = emulate_split_kernel(*t, D ** -0.5, 2, 2, 64)
    assert torch.isnan(ws_ml[0]).all()
    assert (got[0] == 0).all()
    want = _jax_interpret("negative", q, k, v, pos, block_k=64)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


# (batch, Hq, KVH, S_max, SMs)
LAYOUT_SHAPES = [
    (8, 32, 8, 2048, 132),          # the Llama-3-8B decode shape
    (8, 32, 8, 8192, 132),          # its long cache
    (8, 32, 8, 1000, 132),          # a ragged S_max
    (1, 8, 8, 128, 132),            # one slot, group tile 1
    (64, 32, 8, 2048, 132),         # a large batch: few splits
    (3, 24, 8, 77, 132),            # G = 3, one ragged tile
    (4, 16, 2, 4096, 114),          # another SM count
    (8, 32, 8, 2048, 1),            # one SM: one split
    (8, 32, 8, 2048, 1024),         # many SMs: a split a tile
]


@pytest.mark.parametrize("shape", LAYOUT_SHAPES)
def test_layout_is_a_function_of_shapes(shape):
    b, hq, hkv, s_max, sms = shape
    gt, splits, chunk = tda.dense_layout(*shape)
    tiles = -(-s_max // _split.SPLIT_TILE)
    assert gt == _split.group_tile(hq // hkv) and (hq // hkv) % gt == 0
    assert 1 <= splits <= min(tiles, _split.MAX_SPLITS)
    # What the C entry point checks: chunk a whole number of tiles, every
    # split starting below S_max, S_max covered.
    assert chunk % _split.SPLIT_TILE == 0
    assert (splits - 1) * chunk < s_max <= splits * chunk
    rows = b * hq // gt
    # Enough blocks for the card whenever S_max has the tiles for them.
    assert rows * splits >= min(_split.BLOCKS_PER_SM * sms,
                                rows * tiles) / 2
    assert (gt, splits, chunk) == tda.dense_layout(*shape)


def test_dense_and_paged_layouts_agree_over_one_token_count():
    # One chooser serves both kernels: S_max tokens of dense cache and a
    # table of nb blocks of bs tokens over as many tokens split alike.
    from ray_tpu_torch.ops import paged_decode_attention as tpda

    for b, hq, hkv, s_max, sms in LAYOUT_SHAPES:
        if s_max % 64:
            continue
        assert tda.dense_layout(b, hq, hkv, s_max, sms) == \
            tpda.paged_layout(b, hq, hkv, s_max // 64, 64, sms)


def _fake_launch(monkeypatch):
    """Make ``_decode_cuda`` run on CPU tensors with the launch faked; the
    arguments of each launch are appended to the list returned."""
    calls = []
    monkeypatch.setattr(tda, "_kernel_fn", lambda: (
        None, lambda *args: calls.append(args) or 0))
    monkeypatch.setattr(tda, "_num_sms", lambda index: 132)
    monkeypatch.setattr(tda, "_workspaces", {})
    monkeypatch.setattr(torch.cuda, "device",
                        lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda dev: (
        types.SimpleNamespace(cuda_stream=0)))
    return calls


def _cpu_args():
    q, k, v, pos = (torch.from_numpy(a) for a in _inputs())
    return q, _view(k.numpy(), "layer"), _view(v.numpy(), "layer"), pos


def test_split_count_reads_no_position(monkeypatch):
    # The layout _decode_cuda passes (group tile, splits, chunk), and the
    # workspace it hands over, are the same whatever the positions hold.
    calls = _fake_launch(monkeypatch)
    q, k, v, pos = _cpu_args()
    before = tda.decode_attention.launches
    for p in (torch.zeros_like(pos), torch.full_like(pos, S_MAX - 1), pos):
        tda._decode_cuda(q, k, v, p, D ** -0.5)
    assert tda.decode_attention.launches == before + 3
    want = tda.dense_layout(len(POSITIONS), HQ, HKV, S_MAX, 132)
    assert [c[12:15] for c in calls] == [want] * 3    # gt, splits, chunk
    assert len({c[6] - c[5] for c in calls}) == 1      # ws_acc -> ws_ml
    # The shapes and the layer view's strides, as the kernel reads them.
    b = len(POSITIONS)
    assert calls[0][7:12] == (b, HQ, HKV, D, S_MAX)
    assert calls[0][15:20] == (q.stride(0), q.stride(1), *k.stride()[:3])
    assert calls[0][5] - calls[0][6] == -4 * b * HQ * want[1] * D


def test_workspace_is_kept_per_stream_and_grows(monkeypatch):
    calls = _fake_launch(monkeypatch)
    q, k, v, pos = _cpu_args()
    for _ in range(3):
        tda._decode_cuda(q, k, v, pos, D ** -0.5)
    assert len({c[5] for c in calls}) == 1             # one buffer, reused
    (ws,) = tda._workspaces.values()
    _, splits, _ = tda.dense_layout(len(POSITIONS), HQ, HKV, S_MAX, 132)
    assert ws.dtype == torch.float32
    assert ws.numel() == len(POSITIONS) * HQ * splits * (D + 2)
    # A larger batch needs more: the buffer is replaced by a larger one.
    big = [torch.cat([t, t]) for t in (q, k, v, pos)]
    tda._decode_cuda(*big, D ** -0.5)
    (ws2,) = tda._workspaces.values()
    assert ws2.numel() > ws.numel()
    assert calls[-1][5] == ws2.data_ptr()


def test_an_edited_shared_header_renames_both_libraries(tmp_path,
                                                        monkeypatch):
    # Both decode kernels include csrc/split_combine.cuh: a library's name
    # hashes its source and every header, so an edited combine rebuilds
    # the dense and the paged library alike, and nothing else moves them.
    from ray_tpu_torch.ops import _build

    for name in ("dense.cu", "paged.cu", "combine.cuh"):
        (tmp_path / name).write_text(f"// {name}\n")
    monkeypatch.setattr(_build, "CSRC", str(tmp_path))
    before = {n: _build.lib_path(n) for n in ("dense", "paged")}
    assert _build.lib_path("dense") == before["dense"]
    (tmp_path / "combine.cuh").write_text("// combine, edited\n")
    after = {n: _build.lib_path(n) for n in ("dense", "paged")}
    assert all(after[n] != before[n] for n in before)
    (tmp_path / "dense.cu").write_text("// dense, edited\n")
    assert _build.lib_path("dense") != after["dense"]
    assert _build.lib_path("paged") == after["paged"]

"""The split-K (flash-decoding) arithmetic of the paged decode kernel,
emulated on the CPU.

``ray_tpu_torch/ops/csrc/paged_decode_attention.cu`` cuts each slot's
tokens into ``splits`` chunks of whole 64-token tiles. One block walks a
chunk: each of its 4 warps takes 32-token steps (w, w + 4, ...) with its
own fp32 online softmax, the warps merge once into the block's
unnormalised partial (acc, max, sum per query head), and a combine kernel
rescales a row's live partials: ``out = sum_i acc_i e^(m_i - M) /
sum_i l_i e^(m_i - M)`` with ``l == 0 -> 1``. Blocks whose chunk lies past
``pos`` write nothing and the combine reads only the live ones. Here plain
PyTorch repeats those steps, and the result is held to
``paged_attention_reference`` and to the JAX package's
``paged_decode_attention`` in interpret mode. The layout (group tile,
split count, chunk) is chosen on the host from shapes alone
(:func:`paged_layout`), never from ``positions``, and passed to the
kernel.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import paged_kv as jkv
from ray_tpu.ops import paged_decode_attention as jpda
from ray_tpu_torch.models.paged_kv import GARBAGE_BLOCK, quantize_kv
from ray_tpu_torch.ops import paged_decode_attention as tpda

WARPS, STEP = 4, 32            # the kernel's warps a block, tokens a step
HQ, HKV, D, BS, NB = 4, 2, 128, 64, 6          # 6 tiles a slot
# Positions one before, on and one after the edges of 1-, 2- and 3-tile
# chunks (n_tok = pos + 1), the last token, past the table (pos >= nb*bs),
# and a freed slot (pos 0, its whole row on the garbage block).
POSITIONS = (0, 62, 63, 64, 126, 127, 128, 190, 191, 192, 383, 500, 0)
FREED = len(POSITIONS) - 1
TILES = -(-NB * BS // tpda.SPLIT_TILE)
SPLIT_COUNTS = tuple(range(1, TILES + 1)) + (TILES + 2,)   # + dead splits

_jax_out = {}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _inputs(seed=0):
    """numpy fp32 q, arena K/V (slots' blocks at permuted physical ids),
    tables (dead tail entries repeat the last live block) and
    positions."""
    rng = np.random.default_rng(seed)
    b = len(POSITIONS)
    nblocks = b * NB + 1
    q = rng.standard_normal((b, HQ, D)).astype(np.float32)
    k = rng.standard_normal((nblocks, BS, HKV, D)).astype(np.float32)
    v = rng.standard_normal((nblocks, BS, HKV, D)).astype(np.float32)
    tables = rng.permutation(np.arange(1, nblocks)).reshape(b, NB)
    for i, p in enumerate(POSITIONS):
        tables[i, min(p // BS + 1, NB):] = tables[i, min(p // BS, NB - 1)]
    tables[FREED] = GARBAGE_BLOCK
    return q, k, v, tables.astype(np.int32), np.asarray(POSITIONS, np.int32)


def _weight(m, big_m):
    """e^(m - M); an empty partial (m = -inf) weighs exactly 0."""
    return torch.where(m == -torch.inf, torch.zeros_like(m),
                       torch.exp(m - big_m))


def emulate_split_kernel(q, arena_k, arena_v, tables, positions, scale,
                         splits, k_scale=None, v_scale=None):
    """(out in q's dtype, ws_acc [B, Hq, splits, D], ws_ml [B, Hq, splits,
    2]) as the split and combine kernels compute them. Workspace entries
    no block writes stay NaN, so reading one would show in ``out``."""
    b_, hq, d = q.shape
    nb, bs, hkv = tables.shape[1], arena_k.shape[1], arena_k.shape[2]
    kv_of = torch.arange(hq) // (hq // hkv)
    chunk = tpda.split_chunk_tokens(nb, bs, splits)
    ws_acc = torch.full((b_, hq, splits, d), torch.nan)
    ws_ml = torch.full((b_, hq, splits, 2), torch.nan)
    n_toks = [0 if p < 0 else min(int(p) + 1, nb * bs) for p in positions]
    for b, n_tok in enumerate(n_toks):
        toks = torch.arange(n_tok)
        blk, off = tables[b, toks // bs].long(), toks % bs
        k = arena_k[blk, off][:, kv_of].float()          # [T, Hq, D]
        v = arena_v[blk, off][:, kv_of].float()
        if k_scale is not None:
            ks = k_scale[blk, off][:, kv_of].T           # [Hq, T]
            vs = v_scale[blk, off][:, kv_of].T
        for i in range(splits):
            c0, c1 = i * chunk, min((i + 1) * chunk, n_tok)
            if c0 >= n_tok:
                continue                 # the block exits at once
            parts = []
            for w in range(WARPS):
                m = torch.full((hq,), -torch.inf)
                l = torch.zeros(hq)
                acc = torch.zeros(hq, d)
                for t0 in range(c0 + w * STEP, c1, WARPS * STEP):
                    t1 = min(t0 + STEP, c1)
                    s = torch.einsum("hd,thd->ht", q.float()[b], k[t0:t1])
                    if k_scale is not None:
                        s = s * ks[:, t0:t1]
                    s = s * scale
                    m_new = torch.maximum(m, s.amax(dim=1))
                    alpha = torch.exp(m - m_new)
                    e = torch.exp(s - m_new[:, None])
                    l = alpha * l + e.sum(dim=1)
                    m = m_new
                    pw = e * vs[:, t0:t1] if k_scale is not None else e
                    acc = acc * alpha[:, None] + torch.einsum(
                        "ht,thd->hd", pw, v[t0:t1])
                parts.append((m, l, acc))
            big_m = torch.stack([pm for pm, _, _ in parts]).amax(dim=0)
            ws_acc[b, :, i] = sum(pa * _weight(pm, big_m)[:, None]
                                  for pm, _, pa in parts)
            ws_ml[b, :, i, 0] = big_m
            ws_ml[b, :, i, 1] = sum(pl * _weight(pm, big_m)
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
    return out.to(q.dtype), ws_acc, ws_ml


def _jax_interpret(name, q, k, v, tables, pos, **scales):
    """The JAX package's Pallas kernel in interpret mode, once per case."""
    if name not in _jax_out:
        _jax_out[name] = np.asarray(jpda.paged_decode_attention(
            *(jnp.asarray(a) for a in (q, k, v, tables, pos)),
            use_kernel=True, **scales))
    return _jax_out[name]


@pytest.mark.parametrize("splits", SPLIT_COUNTS)
def test_split_emulation_matches_plain_and_jax(pallas_interpret, splits):
    q, k, v, tables, pos = _inputs()
    scale = D ** -0.5
    got, ws_acc, ws_ml = emulate_split_kernel(
        *(torch.from_numpy(a) for a in (q, k, v, tables, pos)), scale,
        splits)
    assert torch.isfinite(got).all()
    ref = tpda.paged_attention_reference(
        *(torch.from_numpy(a) for a in (q, k, v, tables, pos)), scale)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=1e-5)
    want = _jax_interpret("fp32", q, k, v, tables, pos)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
    # Chunks wholly past pos are never written (the block exits) and so
    # never read; the freed slot has exactly one live chunk.
    chunk = tpda.split_chunk_tokens(NB, BS, splits)
    for b, p in enumerate(POSITIONS):
        live = -(-min(p + 1, NB * BS) // chunk)
        assert torch.isfinite(ws_ml[b, :, :live]).all()
        assert torch.isnan(ws_ml[b, :, live:]).all()
        assert torch.isnan(ws_acc[b, :, live:]).all()


@pytest.mark.parametrize("splits", [1, 3, TILES])
def test_split_emulation_int8_matches_plain_and_jax(pallas_interpret,
                                                    splits):
    q, k, v, tables, pos = _inputs(seed=1)
    kq, ks = quantize_kv(torch.from_numpy(k))
    vq, vs = quantize_kv(torch.from_numpy(v))
    t = [torch.from_numpy(a) for a in (q, tables, pos)]
    scale = D ** -0.5
    got, _, _ = emulate_split_kernel(t[0], kq, vq, t[1], t[2], scale, splits,
                                     k_scale=ks, v_scale=vs)
    ref = tpda.paged_attention_reference(t[0], kq, vq, t[1], t[2], scale,
                                         k_scale=ks, v_scale=vs)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=1e-5)
    jkq, jks = jkv.quantize_kv(jnp.asarray(k))
    jvq, jvs = jkv.quantize_kv(jnp.asarray(v))
    if "int8" not in _jax_out:
        _jax_out["int8"] = np.asarray(jpda.paged_decode_attention(
            jnp.asarray(q), jkq, jvq, jnp.asarray(tables), jnp.asarray(pos),
            k_scale=jks, v_scale=jvs, use_kernel=True))
    np.testing.assert_allclose(got.numpy(), _jax_out["int8"], atol=1e-5)


def test_split_emulation_bf16_within_bf16_tolerance():
    q, k, v, tables, pos = _inputs(seed=2)
    t = [torch.from_numpy(a) for a in (q, k, v)]
    q16, k16, v16 = (a.to(torch.bfloat16) for a in t)
    rest = [torch.from_numpy(a) for a in (tables, pos)]
    got, _, _ = emulate_split_kernel(q16, k16, v16, *rest, D ** -0.5, 2)
    ref = tpda.paged_attention_reference(q16, k16, v16, *rest, D ** -0.5)
    assert got.dtype == ref.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), ref.float().numpy(),
                               atol=2e-2, rtol=2e-2)


@pytest.mark.parametrize("shape", [
    (8, 32, 8, 32, 64, 132),         # the Llama-3-8B decode shape
    (1, 8, 8, 128, 64, 132),         # one slot, group tile 1
    (64, 32, 8, 32, 64, 132),        # a large batch: few splits
    (3, 24, 8, 6, 64, 132),          # G = 3: group tile 1
    (2, 4, 2, 4096, 16, 132),        # the longest table
    (4, 16, 2, 12, 64, 114),         # another SM count
])
def test_split_count_is_a_function_of_shapes(shape):
    b, hq, hkv, nb, bs, sms = shape
    splits = tpda.paged_splits(b, hq, hkv, nb, bs, sms)
    tiles = -(-nb * bs // tpda.SPLIT_TILE)
    chunk = tpda.split_chunk_tokens(nb, bs, splits)
    assert 1 <= splits <= min(tiles, tpda.MAX_SPLITS)
    assert chunk % tpda.SPLIT_TILE == 0
    assert chunk * splits >= nb * bs > chunk * (splits - 1)   # none empty
    rows = b * hkv * (hq // hkv // tpda.group_tile(hq // hkv))
    # Enough blocks for the card whenever the table has the tiles for
    # them, and a chunk no longer than needed for that.
    assert rows * splits >= min(tpda.BLOCKS_PER_SM * sms, rows * tiles) / 2
    assert splits == tpda.paged_splits(*shape)


def _fake_launch(monkeypatch):
    """Make ``_paged_cuda`` run on CPU tensors with the launch faked; the
    arguments of each launch are appended to the list returned."""
    import contextlib
    import types

    calls = []
    monkeypatch.setattr(tpda, "_kernel_fn", lambda: (
        None, lambda *args: calls.append(args) or 0))
    monkeypatch.setattr(tpda, "_num_sms", lambda index: 132)
    monkeypatch.setattr(tpda, "_workspaces", {})
    monkeypatch.setattr(torch.cuda, "device",
                        lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda dev: (
        types.SimpleNamespace(cuda_stream=0)))
    return calls


def test_split_count_reads_no_position(monkeypatch):
    # The layout _paged_cuda passes (group tile, splits, chunk), and the
    # workspace it hands over, are the same whatever the positions hold.
    calls = _fake_launch(monkeypatch)
    q, k, v, tables, pos = (torch.from_numpy(a) for a in _inputs())
    before = tpda.paged_decode_attention.launches
    for p in (torch.zeros_like(pos), torch.full_like(pos, NB * BS - 1),
              pos):
        tpda._paged_cuda(q, k, v, tables, p, D ** -0.5, None, None)
    assert tpda.paged_decode_attention.launches == before + 3
    want = tpda.paged_layout(len(POSITIONS), HQ, HKV, NB, BS, 132)
    assert [c[16:19] for c in calls] == [want] * 3    # gt, splits, chunk
    assert len({c[9] - c[8] for c in calls}) == 1      # ws_acc -> ws_ml


@pytest.mark.parametrize("shape", [
    (8, 32, 8, 32, 64, 132), (3, 24, 8, 6, 64, 132), (2, 4, 2, 4096, 16, 132),
    (4, 16, 2, 12, 64, 114)])
def test_layout_is_the_split_count_and_its_chunk(shape):
    b, hq, hkv, nb, bs, sms = shape
    gt, splits, chunk = tpda.paged_layout(*shape)
    assert gt == tpda.group_tile(hq // hkv) and (hq // hkv) % gt == 0
    assert splits == tpda.paged_splits(*shape)
    assert chunk == tpda.split_chunk_tokens(nb, bs, splits)
    # What the C entry point checks: chunk a whole number of tiles, every
    # split starting inside the table, the table covered.
    assert chunk % tpda.SPLIT_TILE == 0
    assert (splits - 1) * chunk < nb * bs <= splits * chunk


def test_workspace_is_kept_per_stream_and_grows(monkeypatch):
    calls = _fake_launch(monkeypatch)
    q, k, v, tables, pos = (torch.from_numpy(a) for a in _inputs())
    for _ in range(3):
        tpda._paged_cuda(q, k, v, tables, pos, D ** -0.5, None, None)
    assert len({c[8] for c in calls}) == 1             # one buffer, reused
    (ws,) = tpda._workspaces.values()
    _, splits, _ = tpda.paged_layout(len(POSITIONS), HQ, HKV, NB, BS, 132)
    assert ws.dtype == torch.float32
    assert ws.numel() == len(POSITIONS) * HQ * splits * (D + 2)
    # A larger batch needs more: the buffer is replaced by a larger one.
    big = [torch.cat([t, t]) for t in (q, tables, pos)]
    tpda._paged_cuda(big[0], k, v, big[1], big[2], D ** -0.5, None, None)
    (ws2,) = tpda._workspaces.values()
    assert ws2.numel() > ws.numel()
    assert calls[-1][8] == ws2.data_ptr()

"""The port's boundary: weights carried across from JAX bit for bit, the
Llama parameter layout, and no JAX or ray_tpu import anywhere in
ray_tpu_torch or chip_smoke.py."""

import os
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import llama as jl
from ray_tpu_torch.interop import params_from_numpy, params_to_numpy
from ray_tpu_torch.models import llama as tl

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + k + ".")
        else:
            yield prefix + k, v


def test_bf16_round_trip_is_bit_exact():
    jp = jax.device_get(jl.init_params(jl.LlamaConfig.tiny(),
                                       jax.random.PRNGKey(0)))
    tp = params_from_numpy(jp, "cpu")
    assert tp["layers"]["wq"].dtype == torch.bfloat16
    back = params_to_numpy(tp, bf16_dtype=jnp.dtype(jnp.bfloat16))
    for (name, a), (_, b) in zip(_leaves(jp), _leaves(back)):
        assert a.dtype == b.dtype and a.shape == b.shape, name
        np.testing.assert_array_equal(a.view(np.uint16), b.view(np.uint16),
                                      err_msg=name)
    bits = params_to_numpy(tp)["lm_head"]
    assert bits.dtype == np.uint16


def test_fp32_round_trip_and_cast():
    jp = jax.device_get(jl.init_params(jl.LlamaConfig.tiny(dtype=jnp.float32),
                                       jax.random.PRNGKey(1)))
    tp = params_from_numpy(jp, "cpu")
    for (name, a), (_, b) in zip(_leaves(jp), _leaves(params_to_numpy(tp))):
        np.testing.assert_array_equal(a, b, err_msg=name)
    cast = params_from_numpy(jp, "cpu", dtype=torch.bfloat16)
    assert cast["embed"].dtype == torch.bfloat16
    assert torch.equal(cast["embed"], tp["embed"].to(torch.bfloat16))


@pytest.mark.parametrize("preset", ["tiny", "llama2_7b", "llama2_13b",
                                    "llama3_8b"])
def test_configs_and_layout_match_jax(preset):
    jc, tc = getattr(jl.LlamaConfig, preset)(), getattr(tl.LlamaConfig,
                                                         preset)()
    for field in ("vocab_size", "hidden_size", "intermediate_size",
                  "num_layers", "num_heads", "num_kv_heads", "head_dim",
                  "max_seq_len", "rope_theta", "rms_eps"):
        assert getattr(tc, field) == getattr(jc, field), field
    assert tl.num_params(tc) == jl.num_params(jc)
    assert tl.logical_axes(tc) == jl.logical_axes(jc)


def test_init_params_shapes_and_distribution():
    cfg = tl.LlamaConfig.tiny(dtype=torch.float32, hidden_size=128,
                              intermediate_size=256)
    gen = torch.Generator().manual_seed(0)
    tp = tl.init_params(cfg, gen, device="cpu")
    jp = jax.eval_shape(lambda: jl.init_params(
        jl.LlamaConfig.tiny(dtype=jnp.float32, hidden_size=128,
                            intermediate_size=256), jax.random.PRNGKey(0)))
    jshapes = dict(_leaves(jp))
    assert sorted(jshapes) == sorted(n for n, _ in _leaves(tp))
    for name, a in _leaves(tp):
        assert tuple(a.shape) == tuple(jshapes[name].shape), name
    assert sum(t.numel() for _, t in _leaves(tp)) == tl.num_params(cfg)
    # normal * fan_in^-0.5: the std of w_down is 256^-0.5.
    assert abs(float(tp["layers"]["w_down"].std()) - 256 ** -0.5) < 2e-3
    assert abs(float(tp["embed"].std()) - 1.0) < 2e-2
    assert torch.equal(tp["final_norm"], torch.ones(128))
    again = tl.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    assert torch.equal(again["layers"]["wq"], tp["layers"]["wq"])


def test_truncated_shares_storage():
    cfg = tl.LlamaConfig.tiny(dtype=torch.float32, num_layers=3)
    tp = tl.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    c2, p2 = tl.truncated(cfg, tp, 2)
    assert c2.num_layers == 2 and p2["layers"]["wq"].shape[0] == 2
    assert p2["layers"]["wq"].data_ptr() == tp["layers"]["wq"].data_ptr()
    assert p2["lm_head"] is tp["lm_head"]
    with pytest.raises(ValueError):
        tl.truncated(cfg, tp, 4)


def test_port_imports_neither_jax_nor_ray_tpu():
    code = (
        "import sys\n"
        "import ray_tpu_torch, ray_tpu_torch.interop\n"
        "import ray_tpu_torch.models.continuous_batching\n"
        "import ray_tpu_torch.ops.paged_decode_attention\n"
        "import ray_tpu_torch.ops.decode_attention\n"
        "import ray_tpu_torch.models.inference\n"
        "import ray_tpu_torch.models.training\n"
        "import ray_tpu_torch.ops.attention\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith('jax.') or m == 'ray_tpu' or "
        "m.startswith('ray_tpu.'))\n"
        "print(bad)\n"
        "assert not bad, bad\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


def test_source_scan_finds_no_jax_or_ray_tpu_import():
    pattern = re.compile(
        r"^\s*(import\s+(jax|ray_tpu)\b(?!_torch)|"
        r"from\s+(jax|ray_tpu)\b(?!_torch))", re.M)
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(os.path.join(REPO, "ray_tpu_torch")):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    assert len(files) >= 12
    for path in files:
        with open(path) as f:
            hits = pattern.findall(f.read())
        assert not hits, (path, hits)

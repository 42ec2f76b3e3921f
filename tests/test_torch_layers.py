"""The port's model building blocks (src/repro_torch/models/layers.py) and
configs against the JAX package's, function by function, on the CPU.

Inputs come from numpy with a seed and go to both sides. fp32 results agree
to float rounding (atol=rtol=2e-5, a few ulps of the O(1) values involved);
bf16 results agree to bf16 rounding (2e-2, as tests/test_kernels.py states
for bf16), since both sides cast at the same places.
"""
import ast
import dataclasses
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import layers as JL
from repro_torch import bridge
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.models import layers as L

ROOT = Path(__file__).resolve().parents[1]

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _tol(dtype):
    return dict(atol=2e-2, rtol=2e-2) if dtype == "bfloat16" else \
        dict(atol=2e-5, rtol=2e-5)


def _pair(rng, shape, dtype="float32", scale=1.0):
    x = (rng.standard_normal(shape) * scale).astype(np.float32)
    jd, td = DTYPES[dtype]
    return jnp.asarray(x).astype(jd), torch.from_numpy(x).to(td)


def _close(got, want, **tol):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), **tol)


# ------------------------------------------------------------- configs

@pytest.mark.parametrize("smoke", [False, True])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_config_copies_match_jax(arch, smoke):
    """Every field the port keeps equals the JAX config's, the family configs
    (moe, ssm, hybrid) field by field; the fields it leaves out belong to
    families not ported yet and are unset in the JAX config, apart from the
    long-context fields (read only by the long_500k shape) and the training
    fields (optimizer, fsdp)."""
    port, ref = get_config(arch, smoke), jax_get_config(arch, smoke)
    for f in dataclasses.fields(port):
        got, want = getattr(port, f.name), getattr(ref, f.name)
        if dataclasses.is_dataclass(want):
            assert dataclasses.asdict(got) == dataclasses.asdict(want), f.name
        else:
            assert got == want, f.name
    for prop in ("eff_q_heads", "eff_kv_heads", "cache_kv_heads",
                 "resolved_head_dim", "padded_vocab"):
        assert getattr(port, prop) == getattr(ref, prop), prop
    for family_field in ("xlstm", "encdec", "vlm"):
        assert getattr(ref, family_field) is None, family_field
    kept = {f.name for f in dataclasses.fields(port)}
    left_out = {f.name for f in dataclasses.fields(ref)} - kept
    assert left_out == {"xlstm", "encdec", "vlm", "long_context_window",
                        "sub_quadratic", "optimizer", "fsdp"}


PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_neither_jax_nor_the_jax_package(path):
    """The port and chip_smoke.py import no `jax` and nothing of `repro`
    (the JAX package), not even a module of it that has no JAX."""
    def banned(name):
        return any(name == m or name.startswith(m + ".") for m in ("jax", "repro"))

    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        assert not any(banned(n) for n in names), f"{path}:{node.lineno} imports {names}"


def test_unported_families_point_to_the_roadmap():
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        get_config("xlstm-350m")
    with pytest.raises(KeyError):
        get_config("no-such-arch")


# ------------------------------------------------------------- elementwise layers

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rms_norm_matches_jax(dtype):
    rng = np.random.default_rng(0)
    jx, x = _pair(rng, (2, 5, 64), dtype, scale=3.0)
    jw, w = _pair(rng, (64,), dtype)
    _close(L.rms_norm(x, w, 1e-5), JL.rms_norm(jx, jw, 1e-5), **_tol(dtype))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("theta", [10000.0, 500000.0])
def test_rope_matches_jax(dtype, theta):
    rng = np.random.default_rng(1)
    jx, x = _pair(rng, (2, 7, 3, 16), dtype)
    pos = (np.arange(7)[None, :] + np.array([[0], [40]])).astype(np.int32)
    _close(L.rope(x, torch.from_numpy(pos), theta),
           JL.rope(jx, jnp.asarray(pos), theta), **_tol(dtype))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_swiglu_matches_jax(dtype):
    rng = np.random.default_rng(2)
    jx, x = _pair(rng, (2, 5, 64), dtype)
    (j1, w1), (j3, w3) = (_pair(rng, (64, 160), dtype, 0.125) for _ in range(2))
    j2, w2 = _pair(rng, (160, 64), dtype, 0.08)
    _close(L.swiglu(x, w1, w3, w2), JL.swiglu(jx, j1, j3, j2), **_tol(dtype))


def test_embed_and_unembed_mask_padded_vocab():
    rng = np.random.default_rng(3)
    jtok, tok = _pair(rng, (256, 32))
    jout, out = _pair(rng, (256, 32))
    jp, p = {"tok": jtok, "out": jout}, {"tok": tok, "out": out}
    ids = rng.integers(0, 250, (2, 6)).astype(np.int32)
    x = L.embed(p, torch.from_numpy(ids))
    _close(x, JL.embed(jp, jnp.asarray(ids)), atol=0, rtol=0)
    logits = L.unembed(p, x, 250)
    _close(logits, JL.unembed(jp, JL.embed(jp, jnp.asarray(ids)), 250),
           atol=2e-5, rtol=2e-5)
    assert bool((logits[..., 250:] == -1e9).all())


# ------------------------------------------------------------- attention

def test_q_head_permutation_matches_jax():
    for args in [(4, 2, 8, 2), (40, 40, 48, 48), (56, 8, 64, 8), (4, 4, 6, 6)]:
        assert L._q_head_permutation(*args) == JL._q_head_permutation(*args)


@pytest.mark.parametrize("arch", ["llama3-8b", "qwen1.5-32b"])
def test_init_attention_pads_heads_like_jax(arch):
    """Padded heads get zero weights at the same places, inside their GQA
    group; the real weights are normal(0, d_model**-0.5) on both sides."""
    cfg = get_config(arch, smoke=True).replace(pad_heads_to=8) if arch == "llama3-8b" \
        else get_config(arch, smoke=True)
    args = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim,
            cfg.qkv_bias)
    pads = (cfg.pad_heads_to, cfg.pad_kv_heads_to)
    jp = JL.init_attention(jax.random.PRNGKey(0), *args, jnp.float32, *pads)
    p = L.init_attention(torch.Generator().manual_seed(0), *args, torch.float32, *pads)
    assert sorted(p) == sorted(jp)
    for name in p:
        want = np.asarray(jp[name])
        assert tuple(p[name].shape) == want.shape, name
        np.testing.assert_array_equal(p[name].numpy() == 0, want == 0, err_msg=name)
    assert abs(p["wq"][p["wq"] != 0].std().item() - cfg.d_model ** -0.5) < 0.02


@pytest.mark.parametrize("window", [None, 8])
@pytest.mark.parametrize("arch,dtype", [("llama3-8b", "float32"),
                                        ("qwen1.5-32b", "float32"),
                                        ("llama3-8b", "bfloat16")])
def test_attention_matches_jax(arch, dtype, window):
    cfg = get_config(arch, smoke=True).replace(param_dtype=dtype)
    jcfg = jax_get_config(arch, smoke=True).replace(param_dtype=dtype)
    jp = JL.init_attention(jax.random.PRNGKey(4), cfg.d_model, cfg.n_heads,
                           cfg.n_kv_heads, cfg.resolved_head_dim, cfg.qkv_bias,
                           DTYPES[dtype][0], cfg.pad_heads_to, cfg.pad_kv_heads_to)
    if cfg.qkv_bias:   # nonzero biases, so that the test sees them
        jp = {k: (v + 0.1 * jnp.arange(v.shape[0], dtype=v.dtype) / v.shape[0])
              if k.startswith("b") else v for k, v in jp.items()}
    p = {k: bridge.tensor_from_array(v) for k, v in jp.items()}
    rng = np.random.default_rng(5)
    jx, x = _pair(rng, (2, 16, cfg.d_model), dtype)
    pos = np.broadcast_to(np.arange(16, dtype=np.int32), (2, 16))
    out, (k, v) = L.attention(p, x, torch.from_numpy(pos.copy()), cfg, window=window)
    jout, (jk, jv) = JL.attention(jp, jx, jnp.asarray(pos), jcfg, window=window,
                                  block_q=8, block_k=8)
    _close(out, jout, **_tol(dtype))
    _close(k, jk, **_tol(dtype))
    _close(v, jv, **_tol(dtype))

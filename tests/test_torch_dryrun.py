"""The port's dry-run slice against the JAX package's: the shapes and their
applicability, the analytic parameter counts, the input and cache specs,
`model_flops` and the roofline arithmetic, the kernel ops' cost formulas
and meta outputs, the FLOPs and argument bytes of the reference's compiled
steps, the ZeRO state per rank, and `launch/dryrun.py` end to end at SMOKE.

The reference's `launch/dryrun.py` sets XLA_FLAGS when imported, so it is
read here with `ast` (its MICROBATCH table), never imported. JAX meshes
are stand-ins with `axis_names` and `devices.shape`, as
tests/test_torch_sharding.py builds them. The port's steps run on the meta
device, and on the CPU with each kernel op given its plain version as a CPU
kernel (`cpu_kernel_ops`), so that the CPU step runs the same ops as the
card's and its account can be held to the meta account op for op.
"""
import ast
import dataclasses
import functools
import importlib.util
import math
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import roofline as JR
from repro.configs import SHAPES as JSHAPES
from repro.configs import active_param_count as j_active
from repro.configs import applicable as j_applicable
from repro.configs import get_config as jax_get_config
from repro.configs import param_count as j_params
from repro.models import build_model as jax_build_model
from repro.models import registry as JM
from repro.optim import optimizers as JO
from repro.sharding import axes as JA
from repro.sharding import rules as JRU
from repro.train import steps as JS
from repro_torch import bridge
from repro_torch import roofline as R
from repro_torch.configs import (ARCH_IDS, SHAPES, active_param_count, applicable, get_config,
                                 param_count)
from repro_torch.kernels import costs, ops, ref
from repro_torch.launch import dryrun as D
from repro_torch.launch.mesh import Mesh, make_production_mesh
from repro_torch.models import registry as M
from repro_torch.optim.optimizers import make_optimizer
from repro_torch.sharding import axes as A
from repro_torch.sharding import rules as RU
from repro_torch.train.steps import train_state
from repro_torch.tree import flatten, leaves

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DTYPES = {jnp.int32: torch.int32, jnp.bfloat16: torch.bfloat16, jnp.float32: torch.float32,
          jnp.int8: torch.int8}
# the SMOKE sweep cuts each shape's length and batch, as SMOKE cuts widths:
# the xLSTM's sLSTM runs one step a token, ~50 meta ops each
SMOKE_SHAPE = {"seq_len": 32, "global_batch": 8}


def _torch_dtype(dt):
    return DTYPES[jnp.dtype(dt).type]


def _jax_leaves(tree):
    return {tuple(str(getattr(e, "key", getattr(e, "idx", e))) for e in path): leaf
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _jax_mesh(shape, axes):
    return types.SimpleNamespace(axis_names=axes, devices=np.empty(shape, dtype=np.int8))


# ----------------------------------------------------------------------------
# 1-2. shapes, applicability, counts
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCH_IDS)
def test_shapes_and_applicable_match_jax(arch):
    assert {k: dataclasses.astuple(v) for k, v in SHAPES.items()} == \
        {k: dataclasses.astuple(v) for k, v in JSHAPES.items()}
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    for name in SHAPES:
        assert applicable(cfg.family, cfg.sub_quadratic, name) == \
            j_applicable(jcfg.family, jcfg.sub_quadratic, name), name


@pytest.mark.parametrize("smoke", [False, True])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_counts_match_jax(arch, smoke):
    cfg, jcfg = get_config(arch, smoke), jax_get_config(arch, smoke)
    assert param_count(cfg) == j_params(jcfg)
    assert active_param_count(cfg) == j_active(jcfg)
    assert cfg.n_rep == jcfg.n_rep
    assert (cfg.long_context_window, cfg.sub_quadratic, cfg.optimizer) == \
        (jcfg.long_context_window, jcfg.sub_quadratic, jcfg.optimizer)


# ----------------------------------------------------------------------------
# 3-5. input specs, cache specs, window, make_batch
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCH_IDS)
def test_input_specs_match_jax(arch):
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    for name, shape in SHAPES.items():
        got = M.input_specs(cfg, shape)
        want = JM.input_specs(jcfg, JSHAPES[name])
        assert got.keys() == want.keys(), name
        for k, s in want.items():
            assert got[k].device.type == "meta"
            want_k = (s.shape, _torch_dtype(s.dtype))
            assert (tuple(got[k].shape), got[k].dtype) == want_k, (name, k)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_cache_specs_match_jax(arch):
    """Every applicable decode cell's cache, zamba2's windowed and xlstm's
    long_500k ones included, through the port's stacked view."""
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    for name, shape in SHAPES.items():
        if shape.kind != "decode" or not applicable(cfg.family, cfg.sub_quadratic, name):
            continue
        window = M.shape_window(cfg, shape)
        assert window == JM.shape_window(jcfg, JSHAPES[name])
        got = RU.stacked_view(M.cache_specs(cfg, shape, window=window))
        want = _jax_leaves(JM.cache_specs(jcfg, JSHAPES[name], window=window))
        port = {p: (s.shape, leaf.dtype) for (p, s), leaf in
                zip(got.items(), [l for _, l in flatten(M.cache_specs(cfg, shape, window))])}
        assert port == {p: (tuple(l.shape), _torch_dtype(l.dtype)) for p, l in want.items()}, name


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_shape_window_and_make_batch(arch):
    cfg, jcfg = get_config(arch, smoke=True), jax_get_config(arch, smoke=True)
    for name, shape in SHAPES.items():
        assert M.shape_window(cfg, shape) == JM.shape_window(jcfg, JSHAPES[name])
        small = dataclasses.replace(shape, **SMOKE_SHAPE)
        specs = M.input_specs(cfg, small)
        batch = M.make_batch(cfg, small, device="cpu",
                             generator=torch.Generator().manual_seed(1))
        assert batch.keys() == specs.keys()
        for k, t in batch.items():
            assert (t.shape, t.dtype, t.device.type) == (specs[k].shape, specs[k].dtype, "cpu")
            if k == "positions":
                assert not t.any()
            elif t.dtype == torch.int32:
                assert 0 <= int(t.min()) and int(t.max()) < cfg.vocab_size
            else:
                assert torch.isfinite(t.float()).all()
        meta = M.make_batch(cfg, small, device="meta")
        assert all(t.device.type == "meta" for t in meta.values())


# ----------------------------------------------------------------------------
# 6. model_flops and the roofline arithmetic
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCH_IDS)
def test_model_flops_match_jax(arch):
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    for name, shape in SHAPES.items():
        got, want = R.model_flops(cfg, shape), JR.model_flops(jcfg, JSHAPES[name])
        assert got == pytest.approx(want, rel=1e-12), name


def test_roofline_arithmetic_matches_jax(monkeypatch):
    """The same CostTotals through both sides' roofline_terms,
    dominant_term and roofline_fraction: each side's constants, the
    reference's arithmetic."""
    colls = {"all-reduce": [3.0, 4e9, 6e9], "all-gather": [1.0, 1e8, 3e8]}
    for flops, nbytes in ((1e15, 1e12), (1e12, 1e13), (1e9, 1e6)):
        jc = JR.CostTotals(flops=flops, bytes=nbytes, collectives=colls)
        pc = R.CostTotals(flops=flops, bytes=nbytes, collectives=colls)
        ref_terms = JR.roofline_terms(jc)
        assert ref_terms["compute_s"] == flops / 197e12
        monkeypatch.setattr(JR, "PEAK_FLOPS", R.PEAK_FLOPS)
        monkeypatch.setattr(JR, "HBM_BW", R.HBM_BW)
        monkeypatch.setattr(JR, "LINK_BW", R.LINK_BW)
        want, got = JR.roofline_terms(jc), R.roofline_terms(pc)
        monkeypatch.undo()
        assert got == want
        assert R.dominant_term(got) == JR.dominant_term(want)
        assert R.roofline_fraction(got) == JR.roofline_fraction(want)
    assert (R.PEAK_FLOPS, R.HBM_BW, R.HBM_BYTES, R.LINK_BW) == (989e12, 3.35e12, 80 * 2**30,
                                                                 450e9)


# ----------------------------------------------------------------------------
# 7. the kernel ops' cost formulas and meta outputs
# ----------------------------------------------------------------------------

# the bounds PERF.md's kernel table records, at their shapes (ms, bound_by);
# decode's 10272 valid rows are phase 3b's draw (chip_smoke.py, seed 0)
PERF_BOUNDS = {
    "flash": (costs.flash_cost(1, 32, 8, 1024, 1024, 128), R.PEAK_FLOPS, 0.00869, "operations"),
    "decode": (costs.decode_cost(8, 32, 16, 2048, 128, rows=10272), R.PEAK_FLOPS, 0.02516,
               "bytes"),
    "moe_gmm": (costs.gmm_cost(16, 4, 4096, 6400), R.PEAK_FLOPS, 0.2508, "bytes"),
    "moe_gmm_dx": (costs.gmm_cost(16, 320, 6400, 4096), R.PEAK_FLOPS, 0.2825, "bytes"),
    "ssd_scan": (costs.ssd_cost(4, 80, 1024, 64, 1, 64, 256, 4), R.PEAK_TF32_FLOPS, 0.0527,
                 "bytes"),
}


@pytest.mark.parametrize("name", list(PERF_BOUNDS))
def test_kernel_cost_formulas_give_perf_md_bounds(name):
    (flops, nbytes), peak, want_ms, by = PERF_BOUNDS[name]
    seconds, bound_by = R.bound(flops, nbytes, peak)
    assert seconds * 1e3 == pytest.approx(want_ms, rel=1e-3)
    assert bound_by == by


def _meta_like(t):
    return torch.empty_strided(t.shape, t.stride(), dtype=t.dtype, device="meta")


def _kernel_cases():
    g = torch.Generator().manual_seed(0)
    rnd = lambda *s, dt=torch.float32: torch.randn(s, generator=g).to(dt)   # noqa: E731
    q = rnd(2, 16, 4, 16).transpose(1, 2)
    k = rnd(2, 16, 2, 16).transpose(1, 2)
    valid = torch.tensor([3, 16], dtype=torch.int32)
    k8 = torch.randint(-127, 128, (2, 16, 2, 16), generator=g, dtype=torch.int8).transpose(1, 2)
    sc = rnd(2, 16, 2, 1).abs().transpose(1, 2)
    x = rnd(2, 64, 4, 16).transpose(1, 2)
    dt = rnd(2, 64, 4).abs().transpose(1, 2)
    bm = rnd(2, 64, 1, 16).transpose(1, 2)
    e = rnd(4, 8, 32, dt=torch.bfloat16)
    w = rnd(4, 32, 48, dt=torch.bfloat16)
    dy = rnd(4, 8, 48, dt=torch.bfloat16)
    return {
        "flash_attention": (lambda *a: ops.flash_attention(*a, causal=True), (q, k, k)),
        "flash_attention_lse": (lambda *a: ops.flash_attention(*a, window=5, return_lse=True),
                                (q, k, k)),
        "decode_attention": (ops.decode_attention, (q[:, :, 0], k, k, valid)),
        "decode_attention_int8": (ops.decode_attention, (q[:, :, 0], k8, k8, valid, sc, sc)),
        "moe_gmm": (ops.moe_gmm, (e, w)),
        "moe_gmm_dx": (ops.moe_gmm_dx, (dy, w)),
        "moe_gmm_dw": (ops.moe_gmm_dw, (e, dy)),
        "ssd_scan": (lambda *a: ops.ssd_scan(*a, chunk=32), (x, dt, -rnd(4).abs(), bm, bm)),
    }


@pytest.mark.parametrize("case", list(_kernel_cases()))
def test_kernel_ops_meta_outputs_match_plain(case):
    """Each op on meta tensors gives its plain version's output shapes,
    dtypes and strides, counted by the CostModel as one kernel op with its
    formula's FLOPs and bytes (its inputs read and outputs written once)."""
    fn, args = _kernel_cases()[case]
    want = fn(*args)
    meta_args = tuple(_meta_like(a) for a in args)
    with R.CostModel("meta") as cm:
        got = fn(*meta_args)
    want, got = (want, got) if isinstance(want, tuple) else ((want,), (got,))
    for w, t in zip(want, got):
        assert (t.device.type, t.shape, t.dtype) == ("meta", w.shape, w.dtype)
    assert got[0].stride() == torch.empty_like(meta_args[0]).stride() or case.startswith(
        ("decode", "moe"))
    assert sum(cm.kernels.values()) == 1 and len(cm.by_op) == 1
    io = sum(R.tensor_bytes(t) for t in meta_args + got)
    (name, (calls, flops, nbytes)), = cm.by_op.items()
    assert nbytes == io
    assert flops == cm.totals.flops > 0


# ----------------------------------------------------------------------------
# 8-9. FLOPs and argument bytes against the reference's compiled steps
# ----------------------------------------------------------------------------

def _jax_flops(fn, *args):
    compiled = jax.jit(fn).lower(*args).compile()
    return JR.HloCostModel(compiled.as_text()).entry_cost(), compiled


def _ref_attention_flops(B, Tq, Tk, Hq, Dh, causal, block=512):
    """The block footprint of the reference's flash_attention_ref (its
    layers.py:108-117): each q block's kv blocks, two products a block."""
    bq, bk = min(block, Tq), min(block, Tk)
    nq, nk = Tq // bq, Tk // bk
    steps = sum(min(nk, ((i * bq + bq - 1) // bk) + 1) if causal else nk for i in range(nq))
    return steps * 4 * B * Hq * Dh * bq * bk


@pytest.mark.parametrize("kind", ["prefill", "decode"])
def test_flops_match_jax_after_the_attention_terms(kind):
    """llama3-8b SMOKE's prefill and decode: the port's account against
    HloCostModel of the reference's step lowered on one CPU device, each
    side's attention term taken out and the rest held to 2%."""
    cfg, jcfg = get_config("llama3-8b", smoke=True), jax_get_config("llama3-8b", smoke=True)
    B, T = 2, 64
    Hq, Dh, L = cfg.n_heads, cfg.resolved_head_dim, cfg.n_layers
    jmodel = jax_build_model(jcfg)
    jparams = jax.eval_shape(jmodel.init_params, jax.random.PRNGKey(0))
    if kind == "prefill":
        batch = {"tokens": torch.empty((B, T), dtype=torch.int32, device="meta")}
        acct, _ = D.prefill_account(cfg, batch, device="meta")
        jb = {"tokens": jax.ShapeDtypeStruct((B, T), jnp.int32)}
        jcost, _ = _jax_flops(lambda p, b: jmodel.prefill(p, b), jparams, jb)
        j_attn = L * _ref_attention_flops(B, T, T, Hq, Dh, True)
        p_attn = L * costs.flash_cost(B, Hq, cfg.n_kv_heads, T, T, Dh)[0]
    else:
        cache = M.cache_specs(cfg, SHAPES["decode_32k"], batch=B)
        cache = {k: torch.empty((*v.shape[:2], T, *v.shape[3:]), dtype=v.dtype, device="meta")
                 for k, v in cache.items()}
        batch = {"tokens": torch.empty((B, 1), dtype=torch.int32, device="meta"),
                 "positions": torch.empty((B,), dtype=torch.int32, device="meta")}
        acct, _ = D.decode_account(cfg, batch, cache, device="meta")
        jcache = jax.eval_shape(lambda: jmodel.init_cache(B, T))
        jb = {"tokens": jax.ShapeDtypeStruct((B, 1), jnp.int32),
              "positions": jax.ShapeDtypeStruct((B,), jnp.int32)}
        jcost, _ = _jax_flops(lambda p, c, b: jmodel.decode_step(p, c, b), jparams, jcache, jb)
        j_attn = L * _ref_attention_flops(B, 1, T, Hq, Dh, False)
        p_attn = L * costs.decode_cost(B, Hq, cfg.cache_kv_heads, T, Dh)[0]
    assert acct.cost.kernels == {"flash_attention" if kind == "prefill" else "decode_attention": L}
    got, want = acct.cost.totals.flops - p_attn, jcost.flops - j_attn
    print(f"{kind}: port {acct.cost.totals.flops:.4g} (attention {p_attn:.4g}), "
          f"reference {jcost.flops:.4g} (attention {j_attn:.4g})")
    assert got == pytest.approx(want, rel=2e-2)


def _jax_train(jcfg, B, T, n_micro):
    jmodel = jax_build_model(jcfg)
    opt = JO.make_optimizer("adamw")
    state = jax.eval_shape(JS.make_init_state(jmodel, opt), jax.random.PRNGKey(0))
    step = JS.make_train_step(jmodel, opt, JO.warmup_cosine(3e-4, 2000, 100000),
                              n_microbatches=n_micro)
    batch = {"tokens": jax.ShapeDtypeStruct((B, T), jnp.int32),
             "targets": jax.ShapeDtypeStruct((B, T), jnp.int32)}
    compiled = jax.jit(step, donate_argnums=(0,)).lower(state, batch).compile()
    return compiled


def test_train_argument_bytes_and_totals_against_jax():
    """llama3-8b SMOKE's train step on one rank: the AdamW state and batch
    the port's step is called with equal the reference's argument bytes on
    one CPU device. The FLOP and byte totals of both are printed."""
    cfg, jcfg = get_config("llama3-8b", smoke=True), jax_get_config("llama3-8b", smoke=True)
    B, T, mb = 8, 64, 2
    compiled = _jax_train(jcfg, B, T, mb)
    specs = M.input_specs(cfg, dataclasses.replace(SHAPES["train_4k"], seq_len=T,
                                                   global_batch=B))
    acct, _ = D.train_account(cfg, specs, n_micro=mb, device="meta")
    assert acct.argument_bytes == compiled.memory_analysis().argument_size_in_bytes
    jcost = JR.HloCostModel(compiled.as_text()).entry_cost()
    c = acct.cost.totals
    print(f"train: port {c.flops:.4g} FLOP {c.bytes:.4g} B; reference {jcost.flops:.4g} FLOP "
          f"{jcost.bytes:.4g} B; ratio {c.flops / jcost.flops:.4f}, {c.bytes / jcost.bytes:.4f}")


def _ref_zero_bytes(arch, shape, axes, jcfg=None):
    """Rank 0's bytes of the reference's ZeRO-1 extended blocks (fp32) and
    of its guarded param blocks (param dtype), summed over the leaves, with
    the rules of the mesh (the multi-pod rules where it has a "pod" axis)."""
    jcfg = jcfg or jax_get_config(arch)
    jshapes = jax.eval_shape(jax_build_model(jcfg).init_params, jax.random.PRNGKey(0))
    jmesh = _jax_mesh(shape, axes)
    rules = JA.multi_pod_rules() if "pod" in axes else JA.single_pod_rules()
    sizes = dict(zip(axes, shape))
    pspecs = _jax_leaves(JRU.param_pspecs(jshapes, jcfg, rules))
    zero = param = 0
    for p, leaf in _jax_leaves(jshapes).items():
        guarded = JA._guard_divisibility(jmesh, leaf.shape, pspecs[p])
        z = JA._guard_divisibility(jmesh, leaf.shape,
                                   JRU.zero1_extend(guarded, leaf.shape, jmesh, rules["batch"]))
        for spec, el, acc in ((z, 4, "zero"), (guarded, leaf.dtype.itemsize, "param")):
            n = 1
            for dim, e in zip(leaf.shape, tuple(spec) + (None,) * leaf.ndim):
                names = () if e is None else (e if isinstance(e, tuple) else (e,))
                n *= dim // math.prod(sizes[a] for a in names)
            if acc == "zero":
                zero += n * el
            else:
                param += n * el
    return zero, param


@pytest.mark.parametrize("mesh", ["4x1", "2x4x1", "1x4", "2x4"])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_zero_state_bytes_per_rank_match_jax(arch, mesh):
    """At full width on the meta device, on the (4, 1), (2, 4, 1), (1, 4)
    and (2, 4) meshes: the param bytes rank 0 holds (its model's
    `init_params` under the mesh) equal the reference's guarded param block
    of that rank (`named_shardings`: "model", and the data axes where FSDP
    and the experts put them), and its AdamW moments (ZeRO-1) and ZeRO-2
    accumulator the reference's ZeRO-1 blocks. Every family builds there,
    the xLSTM too since its TP (ROADMAP item 6c) was ported."""
    cfg = get_config(arch)
    mesh = D.MESHES[mesh]
    whole = M.build_model(cfg, device="meta").init_params(torch.Generator())
    rules = A.rules_for(mesh)
    zero, param = _ref_zero_bytes(arch, mesh.shape, mesh.axis_names)
    with D.fake_mesh(mesh) as m:
        g_sh = RU.shardings_for(whole, cfg, m, rules, zero1=True)
        model = M.build_model(cfg, device="meta", mesh=m)
        params = model.init_params(torch.Generator())
        state = train_state(params, make_optimizer("adamw"), g_sh)
    held = sum(t.numel() * t.element_size() for t in leaves(params))
    accum = 4 * sum(p[b].numel() for p, b in zip(leaves(params), g_sh.local_index(params, 0))
                    if b is not None)
    moments = 4 * sum(t.numel() for t in leaves(state["opt"]["m"]))
    assert held == param
    assert accum == moments == zero
    if (cfg.fsdp or cfg.family == "moe") and D.dp_degree(mesh) > 1:   # the data axes cut some
        assert held < sum(t.numel() * t.element_size() for t in leaves(whole)) / mesh.shape[-1]


@pytest.mark.parametrize("arch", ["llama3-8b", "qwen1.5-32b", "phi3.5-moe-42b-a6.6b"])
def test_2x2_train_cell_state_bytes_match_the_reference_shardings(arch):
    """A SMOKE train cell on (2, 2) (qwen1.5-32b with its published FSDP
    put back): rank 0's param, AdamW and ZeRO-2 accumulator bytes equal
    its shards of the reference's `repro.sharding.rules` specs (guarded;
    ZeRO-1 extended for the moments and the accumulator), each shard's
    shape from `NamedSharding.shard_shape` on a JAX mesh with Auto axes."""
    from jax.sharding import AbstractMesh, AxisType, NamedSharding
    fsdp = jax_get_config(arch).fsdp
    over = {"smoke": True, "shape": SMOKE_SHAPE, "config": {"fsdp": fsdp}}
    acct, meta = D.account_cell(arch, "train_4k", D.Mesh((2, 2), ("data", "model")), over)
    jcfg = jax_get_config(arch, smoke=True).replace(fsdp=fsdp)
    jshapes = jax.eval_shape(jax_build_model(jcfg).init_params, jax.random.PRNGKey(0))
    stand_in = _jax_mesh((2, 2), ("data", "model"))
    amesh = AbstractMesh((2, 2), ("data", "model"), axis_types=(AxisType.Auto,) * 2)
    rules = JA.single_pod_rules()
    pspecs = _jax_leaves(JRU.param_pspecs(jshapes, jcfg, rules))
    param = zero = 0
    for p, leaf in _jax_leaves(jshapes).items():
        spec = JA._guard_divisibility(stand_in, leaf.shape, pspecs[p])
        z = JA._guard_divisibility(stand_in, leaf.shape,
                                   JRU.zero1_extend(spec, leaf.shape, stand_in, rules["batch"]))
        param += math.prod(NamedSharding(amesh, spec).shard_shape(leaf.shape)) \
            * leaf.dtype.itemsize
        zero += 4 * math.prod(NamedSharding(amesh, z).shard_shape(leaf.shape))
    assert acct.params_bytes == param
    assert acct.opt_bytes == 2 * zero + 4   # AdamW's m and v, and its int32 step
    assert acct.accum_bytes == zero
    assert meta["dp"] == 2


def test_dryrun_microbatch_table_is_the_reference_s():
    src = open(os.path.join(REPO, "src/repro/launch/dryrun.py")).read()
    tree = ast.parse(src)
    table = next(ast.literal_eval(n.value) for n in tree.body if isinstance(n, ast.Assign)
                 and any(getattr(t, "id", None) == "MICROBATCH" for t in n.targets))
    assert D.MICROBATCH == table


# ----------------------------------------------------------------------------
# 10. the dry-run end to end at SMOKE
# ----------------------------------------------------------------------------

@pytest.fixture(scope="module")
def cpu_kernel_ops():
    """The kernel ops with their plain versions as CPU kernels, their
    outputs laid out as the CUDA kernels lay them out (y and out with the
    input's strides): under `use()` a CPU tensor reaches the custom op, as
    a CUDA tensor does."""
    def like(t, value):
        return torch.empty_like(t).copy_(value)

    def flash(q, k, v, c, w):
        return like(q, ref.flash_attention_ref(q, k, v, causal=c, window=w))

    def flash_lse(q, k, v, c, w):
        out, lse = ref.flash_attention_ref(q, k, v, causal=c, window=w, return_lse=True)
        return like(q, out), lse.contiguous()

    def ssd(x, dt, A_, b, c, chunk):
        y, state = ref.ssd_scan_ref(x, dt, A_, b, c, chunk=chunk)
        return like(x, y), state.contiguous()

    plain = {"flash_attention": flash, "flash_attention_lse": flash_lse,
             "decode_attention": lambda *a: ref.decode_attention_ref(*a).contiguous(),
             "moe_gmm": ref.moe_gmm_ref, "moe_gmm_dx": ref.moe_gmm_dx_ref,
             "moe_gmm_dw": ref.moe_gmm_dw_ref, "ssd_scan": ssd}
    for name, fn in plain.items():
        torch.library.register_kernel(f"repro_torch::{name}", "cpu", fn)

    def use(monkeypatch):
        monkeypatch.setattr(ops, "_kernel_device", lambda t: True)
    return use


def _cell_step_on(device, arch, kind):
    """A SMOKE step of `arch` on `device`: its account."""
    cfg = get_config(arch, smoke=True)
    shape = dataclasses.replace(SHAPES[{"train": "train_4k", "prefill": "prefill_32k",
                                        "decode": "decode_32k"}[kind]], seq_len=32,
                                global_batch=4)
    gen = torch.Generator().manual_seed(0)
    batch = M.make_batch(cfg, shape, device=device, generator=gen)
    if kind == "train":
        acct, _ = D.train_account(cfg, batch, n_micro=2, device=device, generator=gen)
    elif kind == "prefill":
        acct, _ = D.prefill_account(cfg, batch, device=device, generator=gen)
    else:
        model = M.build_model(cfg, device=device)
        cache = model.init_cache(4) if cfg.family == "ssm" else model.init_cache(4, 32)
        acct, _ = D.decode_account(cfg, batch, cache, device=device, generator=gen)
    return acct


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
@pytest.mark.parametrize("arch", ["llama3-8b", "phi3.5-moe-42b-a6.6b", "zamba2-2.7b",
                                  "internvl2-76b"])
def test_meta_account_equals_the_cpu_account(arch, kind, cpu_kernel_ops, monkeypatch):
    """The same SMOKE step on meta tensors and on the CPU (the kernel ops
    given their plain versions as CPU kernels): every op's calls, FLOPs and
    bytes, the kernel ops, the collectives and the live-bytes high-water
    mark are equal (what chip_smoke.py phase 12 holds on the card)."""
    cpu_kernel_ops(monkeypatch)
    meta, cpu = _cell_step_on("meta", arch, kind), _cell_step_on("cpu", arch, kind)
    assert meta.cost.by_op == cpu.cost.by_op
    assert meta.cost.kernels == cpu.cost.kernels and meta.cost.kernels
    assert dataclasses.astuple(meta.cost.totals) == dataclasses.astuple(cpu.cost.totals)
    assert meta.cost.peak_bytes == cpu.cost.peak_bytes
    assert (meta.argument_bytes, meta.output_bytes) == (cpu.argument_bytes, cpu.output_bytes)


def _expected_wire(params, g_sh, n, n_micro):
    """The (4, 1) train step's wire bytes a rank, from the shardings: per
    microbatch each fp32 gradient is all-reduced where every rank holds it
    whole, reduced to the rank owning it whole, reduce-scattered where the
    ranks split it along one dim; after the update each rank's blocks are
    broadcast from their owner or all-gathered; the loss and the squared
    norm are all-reduced as fp32 scalars."""
    blocks = [g_sh.index(params, q) for q in range(n)]
    wire = 0.0
    for j, p in enumerate(leaves(params)):
        bs = [b[j] for b in blocks]
        grad, whole = 4 * p.numel(), p.numel() * p.element_size()
        full = [b is not None and all(s.stop - s.start == d for s, d in zip(b, p.shape))
                for b in bs]
        if all(full):
            wire += n_micro * 2 * grad * (n - 1) / n
        elif sum(b is not None for b in bs) == 1:
            wire += n_micro * grad + whole
        else:
            wire += n_micro * grad * (n - 1) / n + whole / n * (n - 1)
    return wire + 2 * (2 * 4 * (n - 1) / n)


def test_train_wire_bytes_follow_the_shardings():
    cfg = get_config("llama3-8b", smoke=True)
    shape = dataclasses.replace(SHAPES["train_4k"], **SMOKE_SHAPE)
    mesh = make_production_mesh()
    acct, meta = D.account_cell("llama3-8b", "train_4k", mesh,
                                {"smoke": True, "shape": SMOKE_SHAPE})
    params = M.build_model(cfg, device="meta").init_params(torch.Generator())
    g_sh = RU.shardings_for(params, cfg, mesh, A.single_pod_rules(), zero1=True)
    want = _expected_wire(params, g_sh, mesh.size, meta["microbatches"])
    got = sum(v[2] for v in acct.cost.totals.collectives.values())
    assert got == pytest.approx(want, rel=1e-12)
    assert shape.global_batch % (meta["microbatches"] * mesh.size) == 0


@pytest.mark.parametrize("arch", ["qwen1.5-32b", "phi3.5-moe-42b-a6.6b"])
def test_fsdp_and_ep_collectives_of_a_2x2_train_cell(arch):
    """A SMOKE train cell on (2, 2), qwen1.5-32b with its FSDP put back:
    per microbatch the FSDP leaves of every layer are gathered in the
    forward and again in the remat replay, the embeddings' tables once
    each (lookup, logits), and each gather's gradient reduce-scattered
    once; phi3.5-moe's experts take the all-to-all both ways in the
    forward, the replay and the backward. Counted by
    `data_parallel.calls` over rank 0's step on the meta device."""
    from repro_torch.models import data_parallel
    fsdp = jax_get_config(arch).fsdp
    for name in data_parallel.calls:
        data_parallel.calls[name] = 0
    _, meta = D.account_cell(arch, "train_4k", D.Mesh((2, 2), ("data", "model")),
                             {"smoke": True, "shape": SMOKE_SHAPE, "config": {"fsdp": fsdp}})
    cfg, M_ = get_config(arch, smoke=True), meta["microbatches"]
    L = cfg.n_layers
    layer = 7 if fsdp else 0   # wq, wk, wv, wo, w1, w3, w2
    emb = 2 if fsdp else 0
    assert data_parallel.calls == {"dp_all_gather": M_ * (emb + 2 * L * layer),
                                   "dp_reduce_scatter": M_ * (emb + L * layer),
                                   "ep_all_to_all": M_ * 6 * L if cfg.moe else 0}


def test_all_to_all_and_group_collectives_wire_bytes():
    """Over the fake group of a (2, 4) mesh: the experts' all-to-all over
    the "data" group counts as "all-to-all" with the reference's wire
    bytes, b (n - 1) / n; an all-reduce over the "model" group and the FSDP
    gather over "data" count their own group's size, not the world's."""
    from repro_torch import distributed as DI
    from repro_torch.launch.mesh import group_over
    from repro_torch.models.data_parallel import FSDPGather
    with D.fake_mesh(D.MESHES["2x4"]) as m:
        data, model = group_over(m, ("data",)), group_over(m, ("model",))
        x = torch.zeros(64, dtype=torch.float32)
        with R.CostModel("cpu") as cm:
            DI.all_to_all_(torch.empty_like(x), x, data)
            DI.all_reduce_(x, group=model)
            FSDPGather.apply(torch.zeros(8, 16), 1, data)
    coll = cm.totals.collectives
    assert coll["all-to-all"] == [1, 256, 256 * (2 - 1) / 2]
    assert coll["all-reduce"] == [1, 256, 2 * 256 * (4 - 1) / 4]
    assert coll["all-gather"] == [1, 512, 512 * (2 - 1)]


@functools.lru_cache(maxsize=1)
def _tp_spans():
    """chip_smoke.py's `tp_spans`, the one count of the TP collectives that
    the card's phase 16 and these dry-run tests share."""
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  os.path.join(REPO, "chip_smoke.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.tp_spans


def tp_collectives(cfg, kind: str, micro: int = 1, n: int = 4) -> dict:
    """The "model" axis's all-reduces and all-gathers (and reduce-scatters)
    of a hybrid, xLSTM or whisper step on a rank of n, by the dry-run's
    names: `chip_smoke.tp_spans`, what models/mamba2.py, hybrid.py, xlstm.py
    and whisper.py run, the counts that are not 0."""
    spans = _tp_spans()(cfg, n, kind, micro)
    return {op: spans["tp_" + op.replace("-", "_")] for op in
            ("all-reduce", "all-gather", "reduce-scatter")
            if spans["tp_" + op.replace("-", "_")]}


@pytest.mark.parametrize("shape", ["decode_32k", "long_500k"])
def test_tp_spans_count_the_xlstm_s_dry_run_cells_at_full_width(shape, tmp_path):
    """xlstm-350m's 1x4 serving cells at published width (its 4 heads split
    over 4 ranks, the GeGLU's w_ff1 whole) run exactly the TP collectives
    that chip_smoke.py's `tp_spans` counts and phase 16e holds the card's
    ranks to; SMOKE's cells (its 2 heads gathered by column) are
    test_run_cell_on_the_tp_mesh_at_smoke's."""
    cfg = get_config("xlstm-350m")
    rec = D.run_cell("xlstm-350m", shape, D.MESHES["1x4"], out_dir=tmp_path)
    assert rec["status"] == "ok", rec.get("traceback", rec)
    coll = {op: c[0] for op, c in rec["roofline"]["collectives"].items()}
    assert coll == tp_collectives(cfg, SHAPES[shape].kind)
    # 21 mLSTM blocks: w_down's sum, the norm's statistic, w_up's gather; 3
    # sLSTM blocks: h's gather; the embedding's sum, the logits' gather
    assert coll == {"all-reduce": 2 * 21 + 1, "all-gather": 21 + 3 + 1}


@pytest.mark.parametrize("mesh", ["1x1", "4x1", "2x4"])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_run_cell_at_smoke(arch, mesh, tmp_path):
    """run_cell on (1, 1), (4, 1) and (2, 4) for every shape: ok where
    applicable says, skipped where it does not (arctic's train cells are
    accounts of Adafactor with ZeRO-1, whose statistics' sums over the data
    group add all-reduces); on (2, 4) the hybrid's, the xLSTM's and
    whisper's are accounts with the collectives of their TP
    (`tp_collectives`). Each record has the reference's fields."""
    cfg = get_config(arch, smoke=True)
    mesh = D.MESHES[mesh]
    if True:
        for name in SHAPES:
            rec = D.run_cell(arch, name, mesh, overrides={"smoke": True, "shape": SMOKE_SHAPE},
                             out_dir=tmp_path)
            assert (tmp_path / "baseline" / D.mesh_name(mesh) / f"{arch}__{name}.json").exists()
            if not applicable(cfg.family, cfg.sub_quadratic, name):
                assert rec["status"] == "skipped", rec
            else:
                assert rec["status"] == "ok", rec.get("traceback", rec)
                r, m = rec["roofline"], rec["memory"]
                assert r["dominant"] in ("compute_s", "memory_s", "collective_s")
                assert 0 < r["roofline_fraction"] <= 1
                assert r["flops_global"] == r["hlo_flops_per_device"] * mesh.size
                assert m["fits_80gb"] and m["peak_per_device_gb"] > 0
                if SHAPES[name].kind != "train" and mesh.size > 1:
                    # SMOKE's params are far under the reference's 2 GiB a chip
                    assert rec["serve_weights"] == ("tensor-parallel" if mesh.shape[-1] > 1
                                                    else "whole"), rec
                if cfg.optimizer == "adafactor" and SHAPES[name].kind == "train" \
                        and mesh.size > 1:
                    assert rec["roofline"]["collectives"]["all-reduce"][0] > 0, rec
                if mesh.shape[-1] > 1 and cfg.family in ("hybrid", "ssm", "audio"):
                    # ZeRO-2's over "data" come on top in the train step
                    want = tp_collectives(cfg, SHAPES[name].kind, rec.get("microbatches", 1))
                    coll = r["collectives"]
                    for op, count in want.items():
                        assert coll[op][0] == count or (SHAPES[name].kind == "train" and
                                                        coll[op][0] > count), (op, coll)


# ----------------------------------------------------------------------------
# the tensor-parallel serving mesh, 1x4
# ----------------------------------------------------------------------------

TP_CELL_SHAPE = {"seq_len": 320, "global_batch": 2}   # internvl2: 256 patches


@pytest.mark.parametrize("shape", ["prefill_32k", "decode_32k"])
@pytest.mark.parametrize("arch", ["llama3-8b", "qwen1.5-32b", "internvl2-76b",
                                  "phi3.5-moe-42b-a6.6b", "arctic-480b"])
def test_tp_cell_holds_the_rank_s_blocks_and_a_quarter_of_the_flops(arch, shape):
    """Rank 0's account of a serving cell on the (1, 4) mesh at full width
    (the shape cut to 2 x 320): its param bytes are the sum of its blocks
    under the serving specs; its FLOPs are the (1, 1) cell's over 4 but for
    what every rank computes whole, the MoE router (2 N d E a layer); the
    collectives are the two all-reduces a layer, the embedding's and the
    logits' all-gather."""
    cfg = get_config(arch)
    mesh = D.MESHES["1x4"]
    over = {"shape": TP_CELL_SHAPE}
    one, _ = D.account_cell(arch, shape, D.MESHES["1x1"], over)
    four, meta = D.account_cell(arch, shape, mesh, over)
    assert meta["serve_weights"] == "tensor-parallel" and meta["tp"] == 4
    whole = M.build_model(cfg, device="meta").init_params(torch.Generator())
    sh = RU.shardings_for(whole, cfg, mesh, A.single_pod_rules())
    blocks = sum(t[b].numel() * t.element_size()
                 for t, b in zip(leaves(whole), sh.index(whole, 0)))
    assert four.params_bytes == blocks < one.params_bytes
    tokens = TP_CELL_SHAPE["global_batch"] * (TP_CELL_SHAPE["seq_len"]
                                              if shape == "prefill_32k" else 1)
    router = 2 * tokens * cfg.d_model * cfg.moe.n_experts * cfg.n_layers if cfg.moe else 0
    assert four.cost.totals.flops == pytest.approx(one.cost.totals.flops / 4 + 0.75 * router,
                                                   rel=1e-12)
    coll = four.cost.totals.collectives
    assert coll["all-reduce"][0] == 2 * cfg.n_layers + 1
    assert coll["all-gather"][0] == 1
    assert one.cost.totals.collectives == {}


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_run_cell_on_the_tp_mesh_at_smoke(arch, tmp_path):
    """run_cell on (1, 4): every shape ok for every family (the train shape
    through the tensor-parallel train step, no skip; the hybrid's, the
    xLSTM's and whisper's collectives exactly `tp_collectives`), long_500k
    as on (1, 1)."""
    cfg = get_config(arch, smoke=True)
    mesh = D.MESHES["1x4"]
    for name in SHAPES:
        rec = D.run_cell(arch, name, mesh, overrides={"smoke": True, "shape": SMOKE_SHAPE},
                         out_dir=tmp_path)
        if not applicable(cfg.family, cfg.sub_quadratic, name):
            assert rec["status"] == "skipped" and "long_500k" in rec["reason"], rec
        elif cfg.family in ("hybrid", "ssm", "audio"):
            assert rec["status"] == "ok", rec.get("traceback", rec)
            coll = {op: c[0] for op, c in rec["roofline"]["collectives"].items()}
            assert coll == tp_collectives(cfg, SHAPES[name].kind, rec.get("microbatches", 1))
            assert rec.get("serve_weights", "tensor-parallel") == "tensor-parallel"
        else:
            assert rec["status"] == "ok", rec.get("traceback", rec)
            coll = rec["roofline"]["collectives"]
            if SHAPES[name].kind == "train":
                # per microbatch the forward's 2 a layer, the replay's 1 and
                # the backward's 2, the embedding's, the loss's 2 and the
                # unembed input's backward; one for the global norm
                assert coll["all-reduce"][0] >= rec["microbatches"] * (5 * cfg.n_layers + 4) + 1
            else:
                assert rec["serve_weights"] == "tensor-parallel"
                assert coll["all-reduce"][0] >= 2 * cfg.n_layers + 1


@pytest.mark.parametrize("arch", ["llama3-8b", "phi3.5-moe-42b-a6.6b", "arctic-480b"])
def test_tp_train_cell_holds_the_rank_s_blocks_and_a_quarter_of_the_flops(arch):
    """Rank 0's account of train_4k on the (1, 4) mesh at full width (the
    shape cut as TP_CELL_SHAPE cuts it): its param and optimizer bytes are
    the sums of its blocks (AdamW's moments two fp32 copies of its params'
    blocks; arctic's Adafactor statistics those of its blocks), its FLOPs a
    quarter of the single process's on the same batch but for what every
    rank computes whole (the MoE router; the elementwise rest is within
    1e-4 of the total), and its collectives the
    TP step's in both directions: per microbatch 2 all-reduces a layer
    forward, 1 in the remat replay and 2 backward, the embedding's, the
    loss's 2 and the unembed input's, and the global norm's (an MoE layer
    adds the gates' backward one); Adafactor adds its whole-leaf
    statistics' sums."""
    cfg = get_config(arch)
    mesh = D.MESHES["1x4"]
    shape = dataclasses.replace(SHAPES["train_4k"], **TP_CELL_SHAPE)
    four, meta = D.account_cell(arch, "train_4k", mesh, {"shape": TP_CELL_SHAPE})
    mb = meta["microbatches"]
    one, _ = D.train_account(cfg, M.input_specs(cfg, shape), n_micro=mb, device="meta")
    whole = M.build_model(cfg, device="meta").init_params(torch.Generator())
    sh = RU.model_shardings(whole, cfg, mesh, A.single_pod_rules())
    blocks = sum(t[b].numel() * t.element_size()
                 for t, b in zip(leaves(whole), sh.index(whole, 0)))
    assert four.params_bytes == blocks < one.params_bytes
    opt = make_optimizer(cfg.optimizer)
    mine = bridge.shard_train_state(train_state(whole, opt), cfg, mesh, 0)
    assert four.opt_bytes == sum(t.numel() * t.element_size() for t in leaves(mine["opt"]))
    assert four.accum_bytes == 4 * sum(t[b].numel() for t, b in zip(leaves(whole),
                                                                    sh.index(whole, 0)))
    tokens = TP_CELL_SHAPE["global_batch"] * TP_CELL_SHAPE["seq_len"]
    # the router: forward, replay, and its input's and weight's gradients
    router = 4 * 2 * tokens * cfg.d_model * cfg.moe.n_experts * cfg.n_layers if cfg.moe else 0
    assert four.cost.totals.flops == pytest.approx(one.cost.totals.flops / 4 + 0.75 * router,
                                                   rel=1e-4)
    coll = four.cost.totals.collectives
    L = cfg.n_layers
    per_mb = 5 * L + 4 + (L if cfg.family == "moe" else 0)   # the gates' backward
    if cfg.optimizer == "adamw":
        assert coll["all-reduce"][0] == mb * per_mb + 1
    else:
        assert coll["all-reduce"][0] > mb * per_mb + 1
    assert set(coll) == {"all-reduce"}   # full width splits every head: no gather
    assert one.cost.totals.collectives == {}


@pytest.mark.parametrize("arch", ["llama3-8b", "phi3.5-moe-42b-a6.6b"])
def test_tp_train_meta_account_equals_the_cpu_account(arch, cpu_kernel_ops, monkeypatch):
    """Rank 0's SMOKE train step on the (1, 4) mesh over the fake process
    group, on meta tensors and on the CPU (its collectives move no data, so
    the CPU's values are not the model's; the account reads shapes): every
    op, kernel op, collective and the high-water mark equal."""
    cpu_kernel_ops(monkeypatch)
    cfg = get_config(arch, smoke=True)
    shape = dataclasses.replace(SHAPES["train_4k"], seq_len=32, global_batch=4)
    accts = []
    for device in ("meta", "cpu"):
        gen = torch.Generator().manual_seed(0)
        batch = M.make_batch(cfg, shape, device=device, generator=gen)
        with D.fake_group(4):
            acct, _ = D.train_account(cfg, batch, n_micro=2, device=device,
                                      mesh=D.MESHES["1x4"], generator=gen)
        accts.append(acct)
    meta, cpu = accts
    assert meta.cost.by_op == cpu.cost.by_op
    assert meta.cost.kernels == cpu.cost.kernels and meta.cost.kernels
    assert dataclasses.astuple(meta.cost.totals) == dataclasses.astuple(cpu.cost.totals)
    moe = cfg.n_layers if cfg.family == "moe" else 0
    assert meta.cost.totals.collectives["all-reduce"][0] == 2 * (5 * cfg.n_layers + 4 + moe) + 1
    assert meta.cost.peak_bytes == cpu.cost.peak_bytes

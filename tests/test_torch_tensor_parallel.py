"""Tensor-parallel serving of the port over the "model" axis of a (1, n)
mesh (models/tensor_parallel.py, the TP paths of models/layers.py, dense.py,
moe.py and registry.py, launch/mesh.py's groups, sharding/axes.py's
`constrain` and `named_sharding`, sharding/rules.py's `cache_shardings`,
bridge.shard_params) against the JAX package, on the CPU.

Multi-rank cases run in one subprocess per fixture, as
tests/test_torch_distributed.py runs its own: JAX with four host devices
(`--xla_force_host_platform_device_count=4`), the port's ranks gloo
processes on the CPU started by `repro_torch.distributed.spawn` (world
sizes 2 and 4; one spawn per world size serves every case). The rank
bodies are in tests/_torch_tp_ranks.py. Every input comes from numpy with
a seed; every model runs in fp32 with the kernels' plain versions.
Tolerances:
  * logits and caches: atol=rtol=1e-5 (float rounding, sums in another
    order: a partial sum a rank, added in fp32 across the ranks); qwen's
    int8 cache as tests/test_torch_dense.py holds it (codes within 1, scales
    1e-5, dequantised values within a quantisation step + 1e-5);
  * greedy engine outputs, specs and blocks: equal.

Specs. For every dense, MoE and VLM arch, SMOKE and full, on (1, 2), (1, 4)
and (2, 2) meshes: each serving leaf's spec and each rank's block equal
JAX's `named_shardings` on a real four-device mesh (the block from
`devices_indices_map`, the rank at the device's mesh coordinates), and
each cache leaf's spec the JAX dry-run's `cache_shardings`
(`repro.launch.dryrun` is imported only inside the subprocess: it sets
XLA_FLAGS at import, after JAX's devices are up there).

Model parity. llama3-8b SMOKE (at n = 4 wk/wv split by columns into half
heads: k/v gathered, then each rank's q head reads its own kv head),
qwen1.5-32b SMOKE (int8 cache, QKV bias; at n = 4 its 6 padded heads do not
split: q gathered, every rank computes all heads and multiplies its
columns of them by its rows of wo), phi3.5-moe SMOKE (expert-TP, d_ff 96 ->
48 / 24), arctic SMOKE (the dense residual's own split) and internvl2 SMOKE
(patch embeddings), at n = 2 and 4: the prefill logits, each rank's cache
against its block of JAX's, and 4 decode steps' logits and the final cache,
all against JAX's single-device prefill/decode_step on the same bridged
params; the ranks' logits identical; and JAX's own run under a (1, n) mesh
with Auto axes and `axis_rules` against its single-device run.
"""
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.launch.mesh import Mesh, dp_group, tp_group
from repro_torch.models import build_model
from repro_torch.models import dense
from repro_torch.optim.optimizers import make_optimizer
from repro_torch.sharding import axes as A
from repro_torch.sharding.rules import shardings_for
from repro_torch.train.steps import make_train_step, train_state
from repro_torch.tree import flatten

import _torch_subproc as subproc

SERVED = ["llama3-8b", "granite-8b", "qwen1.5-32b", "stablelm-12b", "internvl2-76b",
          "phi3.5-moe-42b-a6.6b", "arctic-480b"]
MESHES = {"1x2": (1, 2), "1x4": (1, 4), "2x2": (2, 2)}
PARITY = [("llama3-8b", 2), ("llama3-8b", 4), ("qwen1.5-32b", 2), ("qwen1.5-32b", 4),
          ("phi3.5-moe-42b-a6.6b", 2), ("phi3.5-moe-42b-a6.6b", 4), ("arctic-480b", 2),
          ("arctic-480b", 4), ("internvl2-76b", 2), ("internvl2-76b", 4)]


def _run(script: str, devices: int) -> dict:
    return subproc.run(script, devices=devices)


@pytest.fixture(scope="module")
def specs():
    return _run("""
        import json
        import numpy as np
        import jax, torch
        from repro.configs import get_config as jget
        from repro.models import build_model as jbuild
        from repro.sharding import axes as JA, rules as JR
        from repro_torch.configs import get_config
        from repro_torch.launch.mesh import Mesh
        from repro_torch.models import build_model
        from repro_torch.sharding import axes as A, rules as R
        from repro_torch.tree import flatten
        import test_torch_tensor_parallel as T
        jax.devices()                     # the four host devices, before the dry-run's flags
        from repro.launch import dryrun as JD

        def norm(spec):
            return [e[0] if isinstance(e, tuple) and len(e) == 1 else
                    (list(e) if isinstance(e, tuple) else e) for e in spec]

        def names(path):
            return tuple(getattr(k, "key", getattr(k, "name", None)) for k in path)

        out = {}
        B, S = 4, 16
        for arch in T.SERVED:
            for smoke in (True, False):
                jcfg, cfg = jget(arch, smoke=smoke), get_config(arch, smoke=smoke)
                jm = jbuild(jcfg)
                jparams = jax.eval_shape(jm.init_params, jax.random.PRNGKey(0))
                jcache = jax.eval_shape(lambda: jm.init_cache(B, S))
                meta = build_model(cfg, device="meta")
                params = meta.init_params(torch.Generator())
                cache = meta.init_cache(B, S)
                for mname, shape in T.MESHES.items():
                    jmesh = jax.make_mesh(shape, ("data", "model"),
                                          axis_types=(jax.sharding.AxisType.Auto,) * 2)
                    mesh = Mesh(shape, ("data", "model"))
                    rules, jrules = A.single_pod_rules(), JA.single_pod_rules()
                    bad = []
                    sh = R.shardings_for(params, cfg, mesh, rules)
                    jsh = JR.named_shardings(jparams, jcfg, jmesh, jrules)
                    for (path, leaf), ns in zip(jax.tree_util.tree_flatten_with_path(jparams)[0],
                                                jax.tree.leaves(jsh)):
                        p = names(path)
                        if norm(sh.specs[p]) != norm(ns.spec):
                            bad.append(["spec", p, norm(sh.specs[p]), norm(ns.spec)])
                        for dev, idx in ns.devices_indices_map(leaf.shape).items():
                            i, j = next(zip(*np.nonzero(jmesh.devices == dev)))
                            rank = int(i) * shape[1] + int(j)
                            want = [[s.start or 0, n if s.stop is None else s.stop]
                                    for s, n in zip(idx, leaf.shape)]
                            got = [[s.start, s.stop] for s in
                                   R.block(leaf.shape, sh.specs[p], mesh, R.coordinate(mesh, rank))]
                            if got != want:
                                bad.append(["block", p, rank, got, want])
                    csh = R.cache_shardings(cache, cfg, mesh, rules, B)
                    jcsh = JD.cache_shardings(jcache, jcfg, jmesh, jrules, B)
                    for (path, leaf), ns in zip(jax.tree_util.tree_flatten_with_path(jcache)[0],
                                                jax.tree.leaves(jcsh)):
                        p = names(path)
                        if norm(csh.specs[p]) != norm(ns.spec):
                            bad.append(["cache", p, norm(csh.specs[p]), norm(ns.spec)])
                    out[f"{arch}/{'smoke' if smoke else 'full'}/{mname}"] = {
                        "bad": bad[:5], "n_leaves": len(sh.specs), "n_cache": len(csh.specs),
                        "model_specs": sum(any(e == "model" or (isinstance(e, tuple)
                                               and "model" in e) for e in s)
                                           for s in sh.specs.values())}
        print(json.dumps(out, default=str))
    """, devices=4)


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("smoke", ["smoke", "full"])
@pytest.mark.parametrize("arch", SERVED)
def test_serving_and_cache_specs_match_jax(specs, arch, smoke, mesh):
    r = specs[f"{arch}/{smoke}/{mesh}"]
    assert r["bad"] == [], r["bad"]
    assert r["n_leaves"] > 0 and r["n_cache"] >= 2
    if MESHES[mesh][1] > 1:   # every config puts some leaf on the model axis
        assert r["model_specs"] > 0


@pytest.fixture(scope="module")
def parity():
    return _run("""
        import json
        import threading
        import numpy as np
        import jax, jax.numpy as jnp
        from repro.configs import get_config as jget
        from repro.models import build_model as jbuild
        from repro.serve import engine as JE
        from repro.sharding import axes as JA, rules as JR
        from repro_torch import distributed as D
        from repro_torch.launch.mesh import Mesh
        from repro_torch.sharding.axes import single_pod_rules
        from repro_torch.sharding.rules import cache_shardings
        from repro_torch.configs import get_config
        import test_torch_tensor_parallel as T
        import _torch_tp_ranks as R

        B, T_, S, STEPS = 2, 12, 16, 4

        def run_jax(jm, jp, batch, steps):
            jl, jpc = jax.jit(jm.prefill)(jp, batch)
            jc = {k: v.at[:, :, :T_].set(jpc[k]) for k, v in jm.init_cache(B, S).items()}
            dec, step = [], jax.jit(jm.decode_step)
            for i, t in enumerate(steps):
                lg, jc = step(jp, jc, {"tokens": jnp.asarray(t),
                                       "positions": jnp.full((B,), T_ + i, jnp.int32)})
                dec.append(np.asarray(lg))
            return (np.asarray(jl), {k: np.asarray(v) for k, v in jpc.items()}, dec,
                    {k: np.asarray(v) for k, v in jc.items()})

        def excess(got, want):
            return float(np.max(np.abs(got - want) - (1e-5 + 1e-5 * np.abs(want))))

        def cache_err(local, want, cfg, n, rank):
            sh = cache_shardings(want, cfg, Mesh((1, n), ("data", "model")),
                                 single_pod_rules(), B)
            blk = {k: want[k][sh.block_of((k,), rank)] for k in want}
            if "k_scale" not in want:
                return {"excess": max(excess(local[k], blk[k]) for k in want)}
            out = {"codes": 0.0, "scale": 0.0, "deq": -1.0}
            for kind in ("k", "v"):
                c, s = local[kind].astype(np.float32), local[kind + "_scale"]
                jc_, js = blk[kind].astype(np.float32), blk[kind + "_scale"]
                out["codes"] = max(out["codes"], float(np.abs(c - jc_).max()))
                out["scale"] = max(out["scale"], excess(s, js))
                out["deq"] = max(out["deq"], float(np.max(np.abs(c * s - jc_ * js)
                                                           - np.maximum(s, js) - 1e-5)))
            return out

        rng = np.random.default_rng(7)
        cases, want, jmesh_err, setup = {}, {}, {}, {}
        for arch, n in T.PARITY:
            key = f"{arch}/{n}"
            if arch not in setup:   # one draw and one single-device run an arch
                jcfg = jget(arch, smoke=True).replace(param_dtype="float32")
                jm = jbuild(jcfg)
                jp = jm.init_params(jax.random.PRNGKey(0))
                batch = {"tokens": rng.integers(0, jcfg.vocab_size, (B, T_)).astype(np.int32)}
                if jcfg.family == "vlm":
                    batch["patch_embeds"] = rng.standard_normal(
                        (B, jcfg.vlm.n_patches, jcfg.d_model)).astype(np.float32)
                steps = [rng.integers(0, jcfg.vocab_size, (B, 1)).astype(np.int32)
                         for _ in range(STEPS)]
                jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
                setup[arch] = (jcfg, jm, jp, batch, steps, jbatch,
                               run_jax(jm, jp, jbatch, steps))
            jcfg, jm, jp, batch, steps, jbatch, want[key] = setup[arch]
            cases.setdefault(n, {})[key] = {"arch": arch, "params": jax.tree.map(np.asarray, jp),
                                            "batch": batch, "S": S, "steps": steps}

        # the engine: JAX's ServeEngine against the port's under the Router at TP 2
        jcfg = jget("llama3-8b", smoke=True).replace(param_dtype="float32")
        jm = jbuild(jcfg)
        jp = jm.init_params(jax.random.PRNGKey(4))
        specs = [([3 + i, 7, 1 + i % 4, 9], 3 + i % 3) for i in range(6)]
        units = (512, 16, np.array([[0, 130, 255, 256], [383, 384, 499, 511]], np.int32),
                 rng.standard_normal((2, 3, 16)).astype(np.float32), 500)
        jobs = {2: {"parity": ("parity_rank", (cases[2],)),
                    "engine": ("engine_rank", (jax.tree.map(np.asarray, jp), specs, 2, 24)),
                    "units": ("units_rank", units)},
                4: {"parity": ("parity_rank", (cases[4],)),
                    "units": ("units_rank", units)}}
        ranks = {}

        def run_ranks():   # the ranks run beside JAX's own runs below
            for n in (2, 4):
                ranks[n] = D.spawn(R.world_rank, n, jobs[n], device="cpu", timeout=240)

        thread = threading.Thread(target=run_ranks)
        thread.start()
        jreqs = [JE.Request(id=i, prompt=list(p), max_new_tokens=m)
                 for i, (p, m) in enumerate(specs)]
        engine = JE.ServeEngine(jm, jp, batch_slots=2, max_len=24)
        for r in jreqs:
            engine.add_request(r)
        engine.run_until_drained()
        for arch, n in T.PARITY:
            key = f"{arch}/{n}"
            jcfg, jm, jp, batch, steps, jbatch, _ = setup[arch]
            mesh = jax.make_mesh((1, n), ("data", "model"),
                                 axis_types=(jax.sharding.AxisType.Auto,) * 2)
            rules = JA.single_pod_rules()
            try:
                jps = jax.device_put(jp, JR.named_shardings(jp, jcfg, mesh, rules))
                with mesh, JA.axis_rules(mesh, rules):
                    got = run_jax(jm, jps, jbatch, steps)
                jmesh_err[key] = max([float(np.abs(got[0] - want[key][0]).max())]
                                     + [float(np.abs(a - b).max())
                                        for a, b in zip(got[2], want[key][2])])
            except Exception as e:
                jmesh_err[key] = f"{type(e).__name__}: {e}"[:300]
        thread.join()

        res = {"parity": {}, "jax_mesh": jmesh_err}
        for arch, n in T.PARITY:
            key = f"{arch}/{n}"
            cfg = get_config(arch, smoke=True)
            wl, wpc, wdec, wc = want[key]
            rs = [r["parity"][key] for r in ranks[n]]
            res["parity"][key] = {
                "prefill": max(excess(r["prefill"], wl) for r in rs),
                "decode": max(excess(a, b) for r in rs for a, b in zip(r["decode"], wdec)),
                "prefill_cache": [cache_err(r["prefill_cache"], wpc, cfg, n, i)
                                  for i, r in enumerate(rs)],
                "cache": [cache_err(r["cache"], wc, cfg, n, i) for i, r in enumerate(rs)],
                "alike": all(np.array_equal(r["prefill"], rs[0]["prefill"])
                             and all(np.array_equal(a, b) for a, b in
                                     zip(r["decode"], rs[0]["decode"])) for r in rs),
                "plan": rs[0]["plan"]}
        res["engine"] = {"jax": [r.output for r in jreqs],
                         "ranks": [r["engine"]["outputs"] for r in ranks[2]],
                         "done": [r["engine"]["done"] for r in ranks[2]]}
        res["units"] = {n: [r["units"] for r in ranks[n]] for n in (2, 4)}
        print(json.dumps(res, default=str))
    """, devices=4)


@pytest.mark.parametrize("arch,n", PARITY)
def test_tp_prefill_and_decode_logits_match_jax(parity, arch, n):
    r = parity["parity"][f"{arch}/{n}"]
    assert r["prefill"] <= 0 and r["decode"] <= 0, r
    assert r["alike"]


@pytest.mark.parametrize("arch,n", PARITY)
def test_tp_caches_are_the_ranks_blocks_of_jax_s(parity, arch, n):
    r = parity["parity"][f"{arch}/{n}"]
    for per_rank in (r["prefill_cache"], r["cache"]):
        assert len(per_rank) == n
        for c in per_rank:
            if "excess" in c:
                assert c["excess"] <= 0, c
            else:   # qwen's int8 cache
                assert c["codes"] <= 1 and c["scale"] <= 0 and c["deq"] <= 0, c


@pytest.mark.parametrize("arch,n", PARITY)
def test_jax_under_a_1xn_mesh_matches_its_single_device_run(parity, arch, n):
    err = parity["jax_mesh"][f"{arch}/{n}"]
    assert isinstance(err, float), err
    assert err <= 1e-5


def test_guard_replication_cases_are_exercised(parity):
    """llama SMOKE at n = 4: q heads split, k/v gathered (wk's columns are
    split into half heads), each rank's q head reads its own kv head, and
    the cache (2 heads) is whole on every rank. qwen SMOKE at n = 4: its 6
    q heads do not split, so q and k/v are gathered and every rank
    multiplies its columns of the heads by its rows of wo."""
    llama, qwen = (parity["parity"][k]["plan"] for k in ("llama3-8b/4", "qwen1.5-32b/4"))
    assert llama["q_split"] and llama["gather_kv"] and llama["kv_heads"]
    assert llama["cache_heads"] == 2
    assert not qwen["q_split"] and qwen["gather_q"] and qwen["gather_kv"]
    assert qwen["out_cols"] and qwen["cache_heads"] == 6
    for key in ("llama3-8b/2", "qwen1.5-32b/2", "phi3.5-moe-42b-a6.6b/2"):
        plan = parity["parity"][key]["plan"]
        assert plan["q_split"] and not plan["gather_kv"] and not plan["kv_heads"]


def test_engine_under_the_router_matches_the_jax_engine(parity):
    """llama3-8b SMOKE at TP 2: every rank's ServeEngine, driven by
    repro.serve.router.Router, gives every request JAX's greedy tokens."""
    e = parity["engine"]
    assert all(d == list(range(6)) for d in e["done"])
    assert e["ranks"][0] == e["ranks"][1] == e["jax"]


@pytest.mark.parametrize("n", [2, 4])
def test_vocab_parallel_embed_and_unembed_match_the_whole_table(parity, n):
    """Tokens at the ranks' row edges; the padded rows (ids >= 500 of 512)
    are -1e9 by global id on every rank."""
    for r in parity["units"][str(n)]:
        assert r["embed"] == 0.0
        assert r["unembed"] <= 1e-5 and r["unembed_masked"]


def test_dp_and_tp_groups_on_a_2x2_mesh(parity):
    """Rank r of a (2, 2) mesh over ("data", "model") sits at (r // 2,
    r % 2): its data-parallel group is its column, its model group its
    row."""
    for rank, r in enumerate(parity["units"]["4"]):
        assert r["dp_group"] == [rank % 2, rank % 2 + 2]
        assert r["tp_group"] == [rank // 2 * 2, rank // 2 * 2 + 1]


# ----------------------------------------------------------------- in process

def test_constrain_checks_the_block_and_is_a_no_op_unbound():
    mesh = Mesh((1, 4), ("data", "model"))
    x = torch.zeros(2, 3, 8, 16)
    assert A.constrain(x, "batch", None, "model", None) is x      # unbound
    assert A.named_sharding("batch", "model") is None
    with A.axis_rules(mesh, A.single_pod_rules()):
        full = (2, 3, 32, 16)
        assert A.constrain(x, "batch", None, "model", None, full=full) is x
        with pytest.raises(ValueError, match="not a rank's block"):
            A.constrain(torch.zeros(full), "batch", None, "model", None, full=full)
        # 6 heads do not split 4 ways: the guard replicates them
        y = torch.zeros(2, 3, 6, 16)
        assert A.constrain(y, "batch", None, "model", None) is y
        with pytest.raises(ValueError):
            A.constrain(torch.zeros(2, 3, 3, 16), "batch", None, "model", None,
                        full=(2, 3, 6, 16))
        assert [str(p) for p in A.named_sharding("batch", None, "model")] == ["S(0)", "S(2)"]


@pytest.mark.parametrize("arch", ["llama3-8b", "qwen1.5-32b", "phi3.5-moe-42b-a6.6b",
                                  "arctic-480b", "internvl2-76b"])
def test_per_rank_init_blocks_are_the_whole_init_s(arch):
    """init_params(mesh=, rank=) draws every leaf whole from the same
    stream and keeps the rank's block: bit for bit the block of the whole
    draw, as shardings_for's serving specs give it."""
    cfg = get_config(arch, smoke=True)
    mesh = Mesh((1, 4), ("data", "model"))
    whole = dense.init_params(torch.Generator().manual_seed(3), cfg, device="cpu")
    sh = shardings_for(whole, cfg, mesh, A.single_pod_rules())
    for rank in range(4):
        mine = dense.init_params(torch.Generator().manual_seed(3), cfg, device="cpu",
                                 mesh=mesh, rank=rank)
        for (path, got), (_, w), b in zip(flatten(mine), flatten(whole),
                                          sh.index(whole, rank)):
            assert torch.equal(got, w[b]), path
            assert got.is_contiguous()
        n_mine = sum(t.numel() for _, t in flatten(mine))
        assert n_mine == sum(w[b].numel() for (_, w), b in
                             zip(flatten(whole), sh.index(whole, rank)))
        assert n_mine < sum(t.numel() for _, t in flatten(whole))


@pytest.mark.parametrize("arch", ["xlstm-350m"])
def test_build_model_refuses_tp_for_the_other_families(arch, monkeypatch):
    """No family is refused a "model" axis any more: the xLSTM, the last
    one (ROADMAP item 6c), builds on (1, 2), rank 1 holding its head of
    SMOKE's two and its block of every split leaf, its cache its head's
    states (tests/test_torch_tp_xlstm.py holds it to JAX)."""
    monkeypatch.setattr(torch.distributed, "get_rank", lambda group=None: 1)
    monkeypatch.setattr(torch.distributed, "get_world_size", lambda group=None: 2)
    cfg = get_config(arch, smoke=True)
    model = build_model(cfg, device="cpu", mesh=Mesh((1, 2), ("data", "model")))
    assert model.tp.xl_heads == slice(1, 2) and model.tp.xl_channels == slice(64, 128)
    params = model.init_params(torch.Generator().manual_seed(0))
    assert params["mlstm"][0][0]["w_q"].shape == (128, 64)
    assert params["slstm"][0]["w_gates"].shape == (64, 128)
    assert model.init_cache(3)["m_C"].shape == (2, 1, 3, 1, 64, 64)


def test_train_step_on_a_model_axis_refuses_only_the_xlstm(monkeypatch):
    """Every family builds on a "model" axis, and its step is made: the
    xLSTM, refused until its TP (ROADMAP item 6c) was ported, too. Adafactor
    trains on every cut:
    arctic-480b on (2, 2) builds, its FSDP and expert leaves the rank's
    blocks, and so does its step, with and without ZeRO-2, and arctic SMOKE's
    ZeRO-2 step on (1, n)'s abstract mesh asks for a data axis as AdamW's
    does. The step refuses ZeRO on a (1, n) mesh (no data axis to shard
    over) and a model built without the step's mesh. The TP model's loss
    trains (tests/test_torch_tp_train.py)."""
    from repro_torch.launch.dryrun import fake_mesh
    with fake_mesh(Mesh((2, 2), ("data", "model"))) as m:
        arctic = build_model(get_config("arctic-480b"), device="meta", mesh=m)
        assert arctic.dp.gathers and torch.distributed.get_world_size(arctic.dp.ep_group) == 2
        assert make_train_step(arctic, make_optimizer("adafactor"), lambda s: 1e-3) is not None
        whole = build_model(get_config("arctic-480b"), device="meta").init_params(
            torch.Generator())
        g_sh = shardings_for(whole, get_config("arctic-480b"), m, A.single_pod_rules(),
                             zero1=True)
        assert make_train_step(arctic, make_optimizer("adafactor"), lambda s: 1e-3,
                               grad_shardings=g_sh) is not None
    monkeypatch.setattr(torch.distributed, "get_rank", lambda group=None: 0)
    monkeypatch.setattr(torch.distributed, "get_world_size", lambda group=None: 2)
    mesh = Mesh((1, 2), ("data", "model"))
    for arch in ("xlstm-350m",):
        xl = build_model(get_config(arch, smoke=True), device="cpu", mesh=mesh)
        assert xl.tp.xl_heads == slice(0, 1) and xl.split.dims
        assert make_train_step(xl, make_optimizer("adamw"), lambda s: 1e-3,
                               mesh=mesh) is not None
    cfg = get_config("llama3-8b", smoke=True)
    with pytest.raises(ValueError, match="build the model under the step's mesh"):
        make_train_step(build_model(cfg, device="cpu"), make_optimizer("adamw"),
                        lambda s: 1e-3, mesh=mesh)
    tp_model = build_model(cfg, device="cpu", mesh=mesh)
    whole = build_model(cfg, device="meta").init_params(torch.Generator())
    with pytest.raises(ValueError, match="has none"):
        make_train_step(tp_model, make_optimizer("adamw"), lambda s: 1e-3,
                        grad_shardings=shardings_for(whole, cfg, mesh, A.single_pod_rules(),
                                                     zero1=True))
    arctic = get_config("arctic-480b", smoke=True)
    with pytest.raises(ValueError, match="has none"):
        make_train_step(build_model(arctic, device="cpu", mesh=mesh), make_optimizer("adafactor"),
                        lambda s: 1e-3, grad_shardings=shardings_for(
                            whole, cfg, mesh, A.single_pod_rules(), zero1=True))
    assert tp_model.loss is not None and tp_model.split.dims


@pytest.mark.parametrize("arch, shape, opt_name", [
    ("llama3-8b", (2, 2), "adamw"), ("phi3.5-moe-42b-a6.6b", (2, 2), "adamw"),
    ("arctic-480b", (1, 2), "adafactor")])
def test_trainer_checkpoints_tp_states_by_their_blocks(tmp_path, arch, shape, opt_name):
    """The Trainer of a tensor-parallel state on a (dp, tp) mesh (where it
    runs ZeRO-2 over "data") or with Adafactor under TP takes the train
    state's shardings: each leaf of the state it draws is the rank's block
    under them, and the "model" axis cuts some optimizer leaves."""
    from repro_torch.checkpoint.checkpointer import Checkpointer
    from repro_torch.data.pipeline import DataConfig, TokenPipeline
    from repro_torch.launch.dryrun import fake_group
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.train.trainer import Trainer, TrainerConfig
    from repro_torch.tree import flatten
    cfg = get_config(arch, smoke=True)
    pipe = TokenPipeline(DataConfig(vocab_size=cfg.vocab_size, seq_len=16, global_batch=4))
    with fake_group(shape[0] * shape[1]):
        model = build_model(cfg, device="meta",
                            mesh=make_mesh(shape, ("data", "model"), device="cpu"))
        t = Trainer(model, make_optimizer(opt_name), pipe, Checkpointer(str(tmp_path)),
                    TrainerConfig())
        assert (t.grad_shardings is not None) == (shape[0] > 1)
        state = train_state(model.init_params(torch.Generator()), t.opt, t.grad_shardings,
                            model.split)
        cut = 0
        for (path, leaf), b in zip(flatten(state), t.shardings.index(state, 0)):
            want = (0,) if b is None else tuple(s.stop - s.start for s in b)
            assert tuple(leaf.shape) == want, (path, tuple(leaf.shape), want)
            cut += path[0] == "opt" and b is not None and want != t.shardings.full_shape(path)
        assert cut > 0


def test_groups_of_abstract_meshes():
    """Where the other axes have size 1 the group is every rank's
    (dist.group.WORLD); a (1, n) mesh has no data-parallel group, a (n, 1)
    mesh no model group."""
    assert dp_group(Mesh((4, 1), ("data", "model"))) is torch.distributed.group.WORLD
    assert tp_group(Mesh((4, 1), ("data", "model"))) is None
    assert dp_group(Mesh((1, 4), ("data", "model"))) is None
    assert tp_group(Mesh((1, 4), ("data", "model"))) is torch.distributed.group.WORLD
    with pytest.raises(ValueError, match="abstract"):
        tp_group(Mesh((2, 2), ("data", "model")))

"""Tensor parallelism of the hybrid (zamba2) and whisper over the "model"
axis, serving and training (models/tensor_parallel.py's SSM plan, `enter`
of several tensors and `shared_sum`; the TP paths of models/mamba2.py,
hybrid.py, whisper.py and layers.py; registry's sharded hybrid and audio
models; bridge.shard_params and shard_train_state over the hybrid's nested
mamba lists and whisper's encoder and decoder layers) against the JAX
package, on the CPU.

One subprocess runs JAX with four host devices
(`--xla_force_host_platform_device_count=4`, Auto axes) and, in a thread
beside JAX's own runs, the port's ranks: gloo processes on the CPU started
by `repro_torch.distributed.spawn`, one spawn per world size (2 and 4)
serving every case; the rank bodies are in tests/_torch_tp_hybrid_ranks.py
(and `train_rank` of tests/_torch_tp_ranks.py). Every input comes from
numpy with a seed; both sides run fp32 on the plain kernels, from the same
JAX-initialised params or train state handed over by the bridge.

Models: zamba2 SMOKE (8 SSM heads of 16, the shared block's 4 heads),
whisper SMOKE (4 heads, which split at n = 2 and 4) and a whisper SMOKE
with 6 heads (d_model 96, both sides), whose heads do not split 4 ways:
at n = 4 q and k/v are gathered by column and each rank multiplies its
columns of the heads by its rows of wo; its 6-head caches stay whole.

Serving, on (1, 2), (1, 4) and for zamba2 on (2, 2) (each data rank its
rows of the batch): the prefill logits (4 x 12 tokens; whisper over 24
encoder frames) and 4 decode steps' logits against JAX's single-device
`prefill`/`decode_step` on the bridged params, atol = rtol = 1e-5
(float rounding, sums in another order across the ranks); the ranks'
logits identical; each rank's k/v (self and cross) and conv caches against
their blocks of JAX's (`cache_shardings`), its SSM state against its heads
of JAX's whole state, at the same tolerance; JAX's own run under a (1, n)
mesh with Auto axes and `axis_rules` against its single-device run.

Training, on (1, 2), (1, 4) and on (2, 2) with ZeRO-2 (4 x 16 tokens, 2
microbatches, AdamW at a constant 1e-2), held as tests/test_torch_tp_train.py
holds the dense family: the loss at the step-0 params within 1e-5; each
gradient block within 1e-4 relative L2 of its block of `jax.grad` of the
single-device loss; every leaf no rank splits (the norms, w_bc, w_dt, the
conv, A_log, D, norm_w: their gradients sum the ranks' partial ones in the
model) bit-identical on every rank; after 2 steps every block of the
params and AdamW state within a hundredth of what the steps moved it (or
1e-5 x sqrt(size)). The first step's loss and grad norm (at the step-0
params) within 1e-5 relative; the second step's within 1e-4: AdamW's first
update is about lr x sign(g), so a gradient entry near zero moves by up
to 2 lr on a rounding of g, and step 2's loss and norm with it (the
single-process port's step-2 grad norm sits 4.3e-5 from JAX's on zamba2's
batch here, JAX's own (1, 4)-mesh step 6.5e-6). The training batch has its
own generator (seed 11, as tests/test_torch_tp_train.py's): the draw that
follows the serving inputs put a whisper embedding gradient entry at
7.6e-8 of a row whose largest is 0.11, where such a flip moved the
entry's first update by lr (12x the params' tolerance) and JAX's own
(1, 4)-mesh step sat at 0.78 of it.

Specs: every leaf's spec and each rank's block equal JAX's
`named_shardings` on (1, 2), (1, 4) and (2, 2), SMOKE and full.
"""
import json
import os
import subprocess
import sys
import textwrap

import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.launch.mesh import Mesh
from repro_torch.models import build_model, hybrid, whisper
from repro_torch.models.tensor_parallel import TensorParallel
from repro_torch.sharding.axes import single_pod_rules
from repro_torch.sharding.rules import model_shardings
from repro_torch.tree import flatten

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT = 300
# name -> (arch, SMOKE overrides)
MODELS = {"zamba2": ("zamba2-2.7b", {}), "whisper": ("whisper-tiny", {}),
          "whisper6": ("whisper-tiny", {"d_model": 96, "n_heads": 6, "n_kv_heads": 6})}
SERVE = {f"{m}/{s[0]}x{s[1]}": (m, s) for m, s in (
    ("zamba2", (1, 2)), ("zamba2", (1, 4)), ("zamba2", (2, 2)), ("whisper", (1, 2)),
    ("whisper", (1, 4)), ("whisper6", (1, 2)), ("whisper6", (1, 4)))}
# name -> (model, mesh shape, ZeRO-2)
TRAIN = {"zamba2/1x2": ("zamba2", (1, 2), False), "zamba2/1x4": ("zamba2", (1, 4), False),
         "zamba2/2x2-zero2": ("zamba2", (2, 2), True),
         "whisper/1x2": ("whisper", (1, 2), False), "whisper/1x4": ("whisper", (1, 4), False),
         "whisper/2x2-zero2": ("whisper", (2, 2), True),
         "whisper6/1x4": ("whisper6", (1, 4), False)}
JAX_MESH = ["zamba2/1x2", "zamba2/1x4", "whisper/1x4", "whisper6/1x4"]
SPEC_MESHES = {"1x2": (1, 2), "1x4": (1, 4), "2x2": (2, 2)}
TOL, LOSS_TOL, GRAD_TOL, STEP_REL, STEP_ABS = 1e-5, 1e-5, 1e-4, 1e-2, 1e-5
METRIC_TOL = (1e-5, 1e-4)   # the steps' loss and grad norm: step 1, step 2


def smoke(model):
    arch, over = MODELS[model]
    return get_config(arch, smoke=True).replace(param_dtype="float32", **over)


SCRIPT = """
    import json
    import threading
    import numpy as np
    import jax, jax.numpy as jnp
    import torch
    from repro.configs import get_config as jget
    from repro.models import build_model as jbuild
    from repro.optim.optimizers import make_optimizer as jopt
    from repro.sharding import axes as JA, rules as JR
    from repro.train import steps as JS
    from repro_torch import bridge
    from repro_torch import distributed as D
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models import build_model
    from repro_torch.sharding.axes import single_pod_rules
    from repro_torch.sharding import rules as R
    from repro_torch.tree import flatten
    import test_torch_tp_hybrid as T
    import _torch_tp_hybrid_ranks as HR

    B, T_, S, STEPS, TE = 4, 12, 16, 4, 24        # serving
    TB, TT, LR, TSTEPS, MICRO = 4, 16, 1e-2, 2, 2  # training
    rng = np.random.default_rng(5)

    def jcfg_of(model):
        arch, over = T.MODELS[model]
        return jget(arch, smoke=True).replace(param_dtype="float32", **over)

    def np_tree(t):
        return jax.tree.map(np.asarray, t)

    def fill(cache, pc):
        return {k: (v.at[:, :, :T_].set(pc[k]) if k in ("k", "v") else pc[k])
                for k, v in cache.items()}

    def run_serve(jm, jp, batch, steps):
        jl, jpc = jax.jit(jm.prefill)(jp, batch)
        jc = fill(jm.init_cache(B, S), jpc)
        dec, step = [], jax.jit(jm.decode_step)
        for i, t in enumerate(steps):
            lg, jc = step(jp, jc, {"tokens": jnp.asarray(t),
                                   "positions": jnp.full((B,), T_ + i, jnp.int32)})
            dec.append(np.asarray(lg))
        return np.asarray(jl), np_tree(jpc), dec, np_tree(jc)

    # ---- serving: one draw and one single-device run a model
    setup, serve_cases = {}, {2: {}, 4: {}}
    for model in T.MODELS:
        jcfg = jcfg_of(model)
        jm = jbuild(jcfg)
        jp = jm.init_params(jax.random.PRNGKey(0))
        batch = {"tokens": rng.integers(0, jcfg.vocab_size, (B, T_)).astype(np.int32)}
        if jcfg.family == "audio":
            batch["enc_embeds"] = rng.standard_normal((B, TE, jcfg.d_model)).astype(np.float32)
        steps = [rng.integers(0, jcfg.vocab_size, (B, 1)).astype(np.int32) for _ in range(STEPS)]
        jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
        setup[model] = dict(cfg=jcfg, model=jm, params=jp, batch=batch, jbatch=jbatch,
                            steps=steps)
    for name, (model, shape) in T.SERVE.items():
        s = setup[model]
        serve_cases[shape[0] * shape[1]][name] = {
            "arch": T.MODELS[model][0], "config": T.MODELS[model][1], "shape": shape,
            "params": np_tree(s["params"]), "batch": s["batch"], "S": S, "steps": s["steps"]}

    # ---- training: JAX's state 0 and a batch a model, from their own generator
    rng = np.random.default_rng(11)
    trefs, train_cases = {}, {2: {}, 4: {}}
    for model in sorted({m for m, _, _ in T.TRAIN.values()}):
        jcfg = jcfg_of(model)
        jm = jbuild(jcfg)
        opt = jopt(jcfg.optimizer)
        state0 = JS.make_init_state(jm, opt)(jax.random.PRNGKey(1))
        tb = {"tokens": rng.integers(0, jcfg.vocab_size, (TB, TT)).astype(np.int32),
              "targets": rng.integers(0, jcfg.vocab_size, (TB, TT)).astype(np.int32)}
        if jcfg.family == "audio":
            tb["enc_embeds"] = rng.standard_normal((TB, TE, jcfg.d_model)).astype(np.float32)
        trefs[model] = dict(cfg=jcfg, model=jm, opt=opt, batch=tb, state0_j=state0,
                            state0=np_tree(state0),
                            jbatch={k: jnp.asarray(v) for k, v in tb.items()})
    for name, (model, shape, zero) in T.TRAIN.items():
        ref = trefs[model]
        train_cases[shape[0] * shape[1]][name] = {
            "arch": T.MODELS[model][0], "config": T.MODELS[model][1], "shape": shape,
            "zero": zero, "state": ref["state0"], "batch": ref["batch"], "lr": LR,
            "steps": TSTEPS, "micro": MICRO}

    ranks = {}

    def run_ranks():   # the ranks run beside JAX's own runs below
        for n in (2, 4):
            jobs = {"serve": ("serve_rank", (serve_cases[n],)),
                    "train": ("train_rank", (train_cases[n],))}
            ranks[n] = D.spawn(HR.world_rank, n, jobs, device="cpu", timeout=240)

    thread = threading.Thread(target=run_ranks)
    thread.start()

    want = {m: run_serve(s["model"], s["params"], s["jbatch"], s["steps"])
            for m, s in setup.items()}
    jax_mesh = {}
    for name in T.JAX_MESH:
        model, shape = T.SERVE[name]
        s = setup[model]
        mesh = jax.make_mesh(shape, ("data", "model"),
                             axis_types=(jax.sharding.AxisType.Auto,) * 2)
        rules = JA.single_pod_rules()
        try:
            jps = jax.device_put(s["params"], JR.named_shardings(s["params"], s["cfg"], mesh,
                                                                 rules))
            with mesh, JA.axis_rules(mesh, rules):
                got = run_serve(s["model"], jps, s["jbatch"], s["steps"])
            jax_mesh[name] = max([float(np.abs(got[0] - want[model][0]).max())]
                                 + [float(np.abs(a - b).max())
                                    for a, b in zip(got[2], want[model][2])])
        except Exception as e:
            jax_mesh[name] = f"{type(e).__name__}: {e}"[:300]
    for ref in trefs.values():
        jm, opt, jb, state0 = ref["model"], ref["opt"], ref["jbatch"], ref["state0_j"]
        loss, grads = jax.jit(jax.value_and_grad(lambda p: jm.loss(p, jb)[0]))(state0["params"])
        step = jax.jit(JS.make_train_step(jm, opt, lambda s: jnp.float32(LR),
                                          n_microbatches=MICRO))
        st, metrics = state0, []
        for _ in range(TSTEPS):
            st, m = step(st, jb)
            metrics.append((float(m["loss"]), float(m["grad_norm"])))
        ref.update(loss=float(loss), grads=np_tree(grads), metrics=metrics, final=np_tree(st))

    # ---- specs: the port's blocks against JAX's named_shardings
    def names(path):
        return tuple(getattr(k, "key", getattr(k, "name", None)) for k in path)

    def norm(spec):
        return [e[0] if isinstance(e, tuple) and len(e) == 1 else
                (list(e) if isinstance(e, tuple) else e) for e in spec]

    specs = {}
    for arch in ("zamba2-2.7b", "whisper-tiny"):
        for sm in (True, False):
            jcfg, cfg = jget(arch, smoke=sm), get_config(arch, smoke=sm)
            jparams = jax.eval_shape(jbuild(jcfg).init_params, jax.random.PRNGKey(0))
            params = build_model(cfg, device="meta").init_params(torch.Generator())
            for mname, shape in T.SPEC_MESHES.items():
                jmesh = jax.make_mesh(shape, ("data", "model"),
                                      axis_types=(jax.sharding.AxisType.Auto,) * 2)
                mesh = Mesh(shape, ("data", "model"))
                sh = R.shardings_for(params, cfg, mesh, single_pod_rules())
                jsh = JR.named_shardings(jparams, jcfg, jmesh, JA.single_pod_rules())
                bad, split = [], 0
                for (path, leaf), ns in zip(jax.tree_util.tree_flatten_with_path(jparams)[0],
                                            jax.tree.leaves(jsh)):
                    p = names(path)
                    if norm(sh.specs[p]) != norm(ns.spec):
                        bad.append(["spec", p, norm(sh.specs[p]), norm(ns.spec)])
                    split += "model" in str(ns.spec)
                    for dev, idx in ns.devices_indices_map(leaf.shape).items():
                        i, j = next(zip(*np.nonzero(jmesh.devices == dev)))
                        rank = int(i) * shape[1] + int(j)
                        w = [[s.start or 0, n if s.stop is None else s.stop]
                             for s, n in zip(idx, leaf.shape)]
                        got = [[s.start, s.stop] for s in
                               R.block(leaf.shape, sh.specs[p], mesh, R.coordinate(mesh, rank))]
                        if got != w:
                            bad.append(["block", p, rank, got, w])
                specs[f"{arch}/{'smoke' if sm else 'full'}/{mname}"] = {
                    "bad": bad[:5], "split": split}
    thread.join()

    def excess(got, w):
        return float(np.max(np.abs(got - w) - (T.TOL + T.TOL * np.abs(w))))

    res = {"serve": {}, "train": {}, "jax_mesh": jax_mesh, "specs": specs}
    for name, (model, shape) in T.SERVE.items():
        n = shape[0] * shape[1]
        cfg = T.smoke(model)
        wl, wpc, wdec, wc = want[model]
        pmesh = Mesh(shape, ("data", "model"))
        rs = [r["serve"][name] for r in ranks[n]]
        caches = []
        for rank, r in enumerate(rs):
            rows = slice(*r["rows"])
            errs = {}
            for kind, got_c, w_c in (("prefill", r["prefill_cache"], wpc), ("final", r["cache"], wc)):
                sh = R.cache_shardings(w_c, cfg, pmesh, single_pod_rules(), B)
                for k, w in w_c.items():
                    blk = w[sh.block_of((k,), rank)]
                    if k == "ssm":   # its heads of the whole state
                        h = r["plan"]["ssm_heads"]
                        blk = blk[:, :, :, h[0]:h[1]]
                    errs[f"{kind}/{k}"] = excess(got_c[k], blk)
            caches.append(errs)
        res["serve"][name] = {
            "prefill": max(excess(r["prefill"], wl[slice(*r["rows"])]) for r in rs),
            "decode": max(excess(a, b[slice(*r["rows"])]) for r in rs
                          for a, b in zip(r["decode"], wdec)),
            "caches": caches,
            "alike": all(np.array_equal(r["prefill"], o["prefill"])
                         and all(np.array_equal(a, b) for a, b in zip(r["decode"], o["decode"]))
                         for r in rs for o in rs if o["rows"] == r["rows"]),
            "plans": [r["plan"] for r in rs]}

    def rel(got, w):
        return float(np.linalg.norm(got - w) / (np.linalg.norm(w) + 1e-8 / T.GRAD_TOL))

    for name, (model, shape, zero) in T.TRAIN.items():
        ref, n = trefs[model], shape[0] * shape[1]
        cfg = T.smoke(model)
        pmesh = Mesh(shape, ("data", "model"))
        rs = [r["train"][name] for r in ranks[n]]
        grads = bridge.params_from_jax(ref["grads"])
        msh = R.model_shardings(grads, cfg, pmesh, single_pod_rules())
        gsh = R.shardings_for(grads, cfg, pmesh, single_pod_rules(), zero1=True) if zero else None
        s0 = bridge.train_state_from_jax(ref["state0"])
        s2 = bridge.train_state_from_jax(ref["final"])
        grad_err, alike, step_err = {}, [], {}
        for rank, r in enumerate(rs):
            wg = {"/".join(map(str, p)): t.numpy() for p, t in flatten(msh.take(grads, rank))}
            for k, g in r["grads"].items():
                grad_err[k] = max(grad_err.get(k, 0.0), rel(g, wg[k]))
            w0, w2 = (bridge.shard_train_state(s, cfg, pmesh, rank, gsh) for s in (s0, s2))
            w0, w2 = ({"/".join(map(str, p)): t.numpy() for p, t in flatten(
                {"params": w["params"], "opt": w["opt"]})} for w in (w0, w2))
            assert set(w2) == set(r["state"]), sorted(set(w2) ^ set(r["state"]))[:5]
            for k, got in r["state"].items():
                want2, start = w2[k].astype(np.float32), w0[k].astype(np.float32)
                tol = max(T.STEP_ABS * np.sqrt(max(got.size, 1)),
                          T.STEP_REL * float(np.linalg.norm(want2 - start)))
                d = float(np.linalg.norm(got - want2))
                step_err[k] = max(step_err.get(k, 0.0), d / tol if tol else d)
        sizes = {"/".join(map(str, p)): t.numel() for p, t in flatten(grads)}
        for k in rs[0]["grads"]:
            if rs[0]["grads"][k].size == sizes[k]:   # a leaf no rank splits
                alike.append([k, all(np.array_equal(r["grads"][k], rs[0]["grads"][k])
                                     for r in rs)])
        res["train"][name] = {
            "loss": [abs(r["loss"] - ref["loss"]) for r in rs],
            "grad_err": grad_err, "alike": alike, "step_err": step_err,
            "metrics": [max(abs(a - b) / abs(b) for r in rs for a, b in
                            zip(r["metrics"][i], ref["metrics"][i])) for i in range(TSTEPS)]}
    print(json.dumps(res, default=str))
"""


@pytest.fixture(scope="module")
def runs():
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    env["PYTHONPATH"] = os.pathsep.join([os.path.join(REPO, "src"), os.path.join(REPO, "tests")])
    out = subprocess.run([sys.executable, "-W", "ignore", "-c", textwrap.dedent(SCRIPT)],
                         capture_output=True, text=True, timeout=TIMEOUT, env=env, cwd=REPO)
    assert out.returncode == 0, f"stdout:\n{out.stdout}\nstderr:\n{out.stderr[-6000:]}"
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("name", list(SERVE))
def test_tp_prefill_and_decode_logits_match_jax(runs, name):
    r = runs["serve"][name]
    assert r["prefill"] <= 0 and r["decode"] <= 0, r
    assert r["alike"]


@pytest.mark.parametrize("name", list(SERVE))
def test_tp_caches_are_the_ranks_blocks_of_jax_s(runs, name):
    """k/v (self and cross) and the conv buffer: the rank's blocks of JAX's
    cache under `cache_shardings`; the SSM state: the rank's heads of JAX's
    whole state (the reference's specs leave it whole)."""
    caches = runs["serve"][name]["caches"]
    assert len(caches) == SERVE[name][1][0] * SERVE[name][1][1]
    for c in caches:
        assert c and all(v <= 0 for v in c.values()), c
    if name.startswith("zamba2"):
        assert {"prefill/ssm", "final/conv"} <= set(caches[0])


@pytest.mark.parametrize("name", JAX_MESH)
def test_jax_under_a_1xn_mesh_matches_its_single_device_run(runs, name):
    err = runs["jax_mesh"][name]
    assert isinstance(err, float), err
    assert err <= 1e-5


@pytest.mark.parametrize("name", list(TRAIN))
def test_tp_loss_and_gradient_blocks_match_jax(runs, name):
    r = runs["train"][name]
    assert max(r["loss"]) <= LOSS_TOL, r["loss"]
    bad = {k: v for k, v in r["grad_err"].items() if not v <= GRAD_TOL}
    assert not bad, bad
    assert len(r["grad_err"]) > 10


@pytest.mark.parametrize("name", list(TRAIN))
def test_replicated_leaves_gradients_are_alike_on_every_rank(runs, name):
    """The leaves no rank splits, among them the ones a rank reads only its
    heads' part of (A_log, D, norm_w, the conv, w_bc, w_dt), have the same
    gradient, bit for bit, on every rank."""
    r = runs["train"][name]
    alike = dict(r["alike"])
    assert alike and all(alike.values()), [k for k, ok in alike.items() if not ok]
    if name.startswith("zamba2"):
        for leaf in ("A_log", "D", "norm_w", "conv_w", "conv_b", "w_bc", "w_dt", "dt_bias"):
            assert any(k.endswith("/" + leaf) for k in alike), leaf


@pytest.mark.parametrize("name", list(TRAIN))
def test_tp_train_steps_match_jax(runs, name):
    r = runs["train"][name]
    bad = {k: v for k, v in r["step_err"].items() if not v <= 1.0}
    assert not bad, bad
    assert any(k.startswith("opt/") for k in r["step_err"])
    assert all(m <= tol for m, tol in zip(r["metrics"], METRIC_TOL)), r["metrics"]


@pytest.mark.parametrize("mesh", list(SPEC_MESHES))
@pytest.mark.parametrize("smoke_", ["smoke", "full"])
@pytest.mark.parametrize("arch", ["zamba2-2.7b", "whisper-tiny"])
def test_param_specs_and_blocks_match_jax(runs, arch, smoke_, mesh):
    r = runs["specs"][f"{arch}/{smoke_}/{mesh}"]
    assert r["bad"] == [], r["bad"]
    assert r["split"] > 0


def test_plans_of_the_guard_cases(runs):
    """The 6-head whisper at n = 4 gathers q and k/v and multiplies its
    columns of the heads (its cache heads whole); at n = 2 its heads split
    3/3. zamba2 SMOKE's 8 SSM heads split 4 and 2 a rank."""
    w6 = runs["serve"]["whisper6/1x4"]["plans"][0]
    assert not w6["q_split"] and w6["gather_q"] and w6["gather_kv"] and w6["out_cols"]
    assert w6["cache_heads"] == 6
    assert runs["serve"]["whisper6/1x2"]["plans"][1]["cache_heads"] == 3
    assert [p["ssm_heads"] for p in runs["serve"]["zamba2/1x4"]["plans"]] == \
        [[0, 2], [2, 4], [4, 6], [6, 8]]
    assert runs["serve"]["zamba2/1x2"]["plans"][1]["ssm_heads"] == [4, 8]


# ----------------------------------------------------------------- in process

def _plan(cfg, n, r, monkeypatch):
    monkeypatch.setattr(torch.distributed, "get_rank", lambda group=None: r)
    monkeypatch.setattr(torch.distributed, "get_world_size", lambda group=None: n)
    return TensorParallel.plan(cfg, None)


def test_full_width_plans(monkeypatch):
    """zamba2-2.7b at n = 4: 20 of its 80 SSM heads a rank (1280 channels,
    the rank's rows of w_out), one B/C group read by all; the shared
    block's 32 heads 8 a rank. whisper-tiny at n = 4: 6 heads gathered by
    column, each rank's 96 columns of them multiplied by its rows of wo;
    at n = 2: 3 heads a rank."""
    z = _plan(get_config("zamba2-2.7b"), 4, 3, monkeypatch)
    assert z.ssm_heads == slice(60, 80) and z.ssm_channels == slice(3840, 5120)
    assert z.ssm_groups == slice(0, 1) and z.gather_zx
    assert z.q_split and z.kv_split and z.cache_heads == 8
    w = _plan(get_config("whisper-tiny"), 4, 1, monkeypatch)
    assert not w.q_split and w.gather_q and w.gather_kv and w.out_cols == slice(96, 192)
    assert w.cache_heads == 6 and w.vocab_rows == slice(12992, 25984)
    assert _plan(get_config("whisper-tiny"), 2, 0, monkeypatch).cache_heads == 3


def test_plan_refuses_ssm_heads_that_do_not_split(monkeypatch):
    """n dividing d_in but not the SSM heads (a zamba2 SMOKE variant of
    d_model 96: 12 heads of 16, d_in 192, at n = 8) would cut a head with
    the guard's blocks of w_zx and w_out: refused, naming the heads."""
    cfg = get_config("zamba2-2.7b", smoke=True).replace(d_model=96)
    assert cfg.ssm.expand * cfg.d_model // cfg.ssm.head_dim == 12
    with pytest.raises(NotImplementedError, match="SSM heads do not split 8 ways"):
        _plan(cfg, 8, 0, monkeypatch)


@pytest.mark.parametrize("shape", [(1, 2), (1, 4), (2, 2)])
@pytest.mark.parametrize("arch", ["zamba2-2.7b", "whisper-tiny"])
def test_per_rank_init_blocks_are_the_whole_init_s(arch, shape):
    """init_params(mesh=, rank=) draws every leaf whole from the same
    stream and keeps the rank's block: bit for bit the block of the whole
    draw under `model_shardings` (SMOKE, on the CPU); at full width on the
    meta device the blocks' shapes."""
    mod = hybrid if arch == "zamba2-2.7b" else whisper
    mesh = Mesh(shape, ("data", "model"))
    for smoke_ in (True, False):
        cfg = get_config(arch, smoke=smoke_)
        dev = "cpu" if smoke_ else "meta"
        gen = (lambda: torch.Generator().manual_seed(3)) if smoke_ else torch.Generator
        whole = mod.init_params(gen(), cfg, device=dev)
        sh = model_shardings(whole, cfg, mesh, single_pod_rules())
        for rank in range(shape[0] * shape[1]):
            mine = mod.init_params(gen(), cfg, device=dev, mesh=mesh, rank=rank)
            for (path, got), (_, w), b in zip(flatten(mine), flatten(whole),
                                              sh.index(whole, rank)):
                assert got.shape == w[b].shape, path
                if smoke_:
                    assert torch.equal(got, w[b]) and got.is_contiguous(), path
            n_mine = sum(t.numel() for _, t in flatten(mine))
            assert n_mine < sum(t.numel() for _, t in flatten(whole))


@pytest.mark.parametrize("arch", ["zamba2-2.7b", "whisper-tiny"])
def test_build_model_on_tp_meshes_at_full_width(arch):
    """On (1, 2), (1, 4) and (2, 2) meshes (fake process groups) the full
    configs build on the meta device: rank 0's params are its blocks, its
    cache its heads', and its Split names every leaf cut over "model"."""
    from repro_torch.launch.dryrun import fake_mesh
    cfg = get_config(arch)
    whole = build_model(cfg, device="meta").init_params(torch.Generator())
    for shape in SPEC_MESHES.values():
        with fake_mesh(Mesh(shape, ("data", "model"))) as m:
            model = build_model(cfg, device="meta", mesh=m)
            mine = model.init_params(torch.Generator())
            sh = model_shardings(whole, cfg, m, single_pod_rules())
            assert [tuple(t.shape) for _, t in flatten(mine)] == \
                [tuple(w[b].shape) for (_, w), b in zip(flatten(whole), sh.index(whole, 0))]
            assert model.split.dims and model.dp is None
            cache = model.init_cache(2, 64)
            n = shape[1]
            assert cache["k"].shape[3] == model.tp.cache_heads
            if arch == "zamba2-2.7b":
                assert cache["ssm"].shape[3] == 80 // n and cache["conv"].shape[-1] == 5248


def test_xlstm_still_refuses_a_model_axis(monkeypatch):
    monkeypatch.setattr(torch.distributed, "get_rank", lambda group=None: 0)
    monkeypatch.setattr(torch.distributed, "get_world_size", lambda group=None: 2)
    with pytest.raises(NotImplementedError, match="item 6c"):
        build_model(get_config("xlstm-350m", smoke=True), device="cpu",
                    mesh=Mesh((1, 2), ("data", "model")))

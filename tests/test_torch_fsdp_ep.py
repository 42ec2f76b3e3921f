"""FSDP and expert parallelism of the port over the "data" axis
(models/data_parallel.py, the FSDP gathers of dense.py, the experts'
all-to-all of moe.py, registry's sharded model on (n, 1) and (dp, tp)
meshes, train/steps.py's data-cut leaves with and without ZeRO-2,
optimizers.Split, bridge.shard_params and shard_train_state of data-cut
blocks) against the JAX package, on the CPU.

One subprocess runs JAX with four host devices
(`--xla_force_host_platform_device_count=4`, Auto axes) and, in a thread
beside JAX's own runs, the port's ranks: gloo processes on the CPU started
by `repro_torch.distributed.spawn`, one spawn per world size (2 and 4)
serving every case; the rank bodies are in tests/_torch_fsdp_ranks.py and
tests/_torch_tp_ranks.py. Every input comes from numpy with a seed; both
sides run fp32 SMOKE configs on the plain kernels, with cfg.fsdp put back
where the published config has it (SMOKE turns it off) and, for serving,
on every arch served here, as the reference's `_serve_cfg` serves them.

Training, held to JAX's single-device `make_train_step` and
`jax.value_and_grad` of its loss on the same state and batch (4 x 16
tokens, 2 microbatches, a constant learning rate of 1e-2), with the bounds
of tests/test_torch_tp_train.py: the loss within 1e-5; each rank's gradient
block within 1e-4 relative L2 of its block of JAX's; two steps within a
hundredth of the update. Cases: qwen1.5-32b (FSDP) on (2, 1) and on (2, 2)
with and without ZeRO-2; internvl2-76b (FSDP, patch embeddings) on (2, 1)
and on (2, 2) with ZeRO-2; phi3.5-moe (EP, with expert-TP on (2, 2)) on
(2, 1) and on (2, 2), each with and without ZeRO-2 (JAX's reference with 2
MoE dispatch groups, as the ranks' data groups give them).

Serving on (2, 2), each data rank its 2 of the 4 rows: the prefill of 12
tokens and 3 greedy decode steps, logits within 1e-5 (absolute and
relative) of JAX's single-device run and the greedy tokens identical.
Cases: qwen1.5-32b (FSDP, its int8 cache), phi3.5-moe (FSDP, EP,
expert-TP), arctic-480b (FSDP, EP, the dense residual) and internvl2-76b
(FSDP, patch embeddings).

JAX's own step on a (2, 2) mesh with FSDP and EP (qwen's and phi's, the
dry-run's state and grad shardings) against its single-device step, held
as the port's steps are; and `FSDPGather`'s and `ExpertAllToAll`'s
backwards, on 2 and 4 ranks.
"""
import json
import os
import subprocess
import sys
import textwrap

import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.launch.dryrun import fake_group
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import build_model
from repro_torch.optim.optimizers import make_optimizer
from repro_torch.train.steps import make_train_step, train_state

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT = 300
# name -> (arch, mesh shape, ZeRO-2)
CASES = {
    "qwen1.5-32b/2x1": ("qwen1.5-32b", (2, 1), False),
    "qwen1.5-32b/2x2": ("qwen1.5-32b", (2, 2), False),
    "qwen1.5-32b/2x2-zero2": ("qwen1.5-32b", (2, 2), True),
    "internvl2-76b/2x1": ("internvl2-76b", (2, 1), False),
    "internvl2-76b/2x2-zero2": ("internvl2-76b", (2, 2), True),
    "phi3.5-moe-42b-a6.6b/2x1": ("phi3.5-moe-42b-a6.6b", (2, 1), False),
    "phi3.5-moe-42b-a6.6b/2x1-zero2": ("phi3.5-moe-42b-a6.6b", (2, 1), True),
    "phi3.5-moe-42b-a6.6b/2x2": ("phi3.5-moe-42b-a6.6b", (2, 2), False),
    "phi3.5-moe-42b-a6.6b/2x2-zero2": ("phi3.5-moe-42b-a6.6b", (2, 2), True),
}
SERVED = ["qwen1.5-32b", "phi3.5-moe-42b-a6.6b", "arctic-480b", "internvl2-76b"]
JAX_MESHES = ["qwen1.5-32b", "phi3.5-moe-42b-a6.6b"]
LOSS_TOL, GRAD_TOL, STEP_REL, STEP_ABS, METRIC_TOL = 1e-5, 1e-4, 1e-2, 1e-5, 1e-5


@pytest.fixture(scope="module")
def runs():
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    env["PYTHONPATH"] = os.pathsep.join([os.path.join(REPO, "src"), os.path.join(REPO, "tests")])
    out = subprocess.run([sys.executable, "-W", "ignore", "-c", textwrap.dedent(SCRIPT)],
                         capture_output=True, text=True, timeout=TIMEOUT, env=env, cwd=REPO)
    assert out.returncode == 0, f"stdout:\n{out.stdout}\nstderr:\n{out.stderr[-6000:]}"
    return json.loads(out.stdout.strip().splitlines()[-1])


SCRIPT = """
    import json
    import threading
    import numpy as np
    import jax, jax.numpy as jnp
    from repro.configs import get_config as jget
    from repro.models import build_model as jbuild
    from repro.optim.optimizers import make_optimizer as jopt
    from repro.sharding import axes as JA
    from repro.train import steps as JS
    from repro_torch import bridge
    from repro_torch import distributed as D
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import Mesh
    from repro_torch.sharding.axes import single_pod_rules
    from repro_torch.sharding.rules import model_shardings, shardings_for
    from repro_torch.tree import flatten
    import test_torch_fsdp_ep as T
    import _torch_fsdp_ranks as R
    jax.devices()                 # the four host devices, before the dry-run's flags
    from repro.launch import dryrun as JD

    B, T_, LR, STEPS, MICRO = 4, 16, 1e-2, 2, 2
    SB, ST, SS, SSTEPS = 4, 12, 16, 3
    rng = np.random.default_rng(13)

    def np_tree(t):
        return jax.tree.map(np.asarray, t)

    def jcfg_of(arch):
        return jget(arch, smoke=True).replace(param_dtype="float32", fsdp=jget(arch).fsdp)

    def setup(arch, groups):
        jcfg = jcfg_of(arch)
        jm = jbuild(jcfg, n_groups=groups)
        opt = jopt("adamw")
        state0 = JS.make_init_state(jm, opt)(jax.random.PRNGKey(0))
        batch = {"tokens": rng.integers(0, jcfg.vocab_size, (B, T_)).astype(np.int32),
                 "targets": rng.integers(0, jcfg.vocab_size, (B, T_)).astype(np.int32)}
        if jcfg.family == "vlm":
            batch["patch_embeds"] = rng.standard_normal(
                (B, jcfg.vlm.n_patches, jcfg.d_model)).astype(np.float32)
        return dict(cfg=jcfg, model=jm, opt=opt, batch=batch,
                    jbatch={k: jnp.asarray(v) for k, v in batch.items()}, state0_j=state0,
                    state0=np_tree(state0))

    def single(ref):
        jm, opt, jb, state0 = ref["model"], ref["opt"], ref["jbatch"], ref["state0_j"]
        loss, grads = jax.jit(jax.value_and_grad(lambda p: jm.loss(p, jb)[0]))(state0["params"])
        step = jax.jit(JS.make_train_step(jm, opt, lambda s: jnp.float32(LR),
                                          n_microbatches=MICRO))
        st, metrics = state0, []
        for _ in range(STEPS):
            st, m = step(st, jb)
            metrics.append((float(m["loss"]), float(m["grad_norm"])))
        ref.update(loss=float(loss), grads=np_tree(grads), metrics=metrics, final=np_tree(st))

    def ref_key(arch, dp):   # the MoE's dispatch groups follow the data axis
        return (arch, dp if jget(arch, smoke=True).family == "moe" else 1)

    refs, cases = {}, {2: {}, 4: {}}
    for name, (arch, shape, zero) in T.CASES.items():
        key = ref_key(arch, shape[0])
        if key not in refs:
            refs[key] = setup(arch, key[1])
        ref = refs[key]
        cases[shape[0] * shape[1]][name] = {
            "arch": arch, "shape": shape, "zero": zero, "fsdp": ref["cfg"].fsdp,
            "state": ref["state0"], "batch": ref["batch"], "lr": LR, "steps": STEPS,
            "micro": MICRO}

    # serving: JAX's single-device prefill and greedy decode, on the whole batch
    serve_cases, serve_want = {}, {}
    for arch in T.SERVED:
        jcfg = jget(arch, smoke=True).replace(param_dtype="float32", fsdp=True)
        jm = jbuild(jcfg, n_groups=2)
        jp = jm.init_params(jax.random.PRNGKey(1))
        batch = {"tokens": rng.integers(0, jcfg.vocab_size, (SB, ST)).astype(np.int32)}
        if jcfg.family == "vlm":
            batch["patch_embeds"] = rng.standard_normal(
                (SB, jcfg.vlm.n_patches, jcfg.d_model)).astype(np.float32)
        serve_cases[arch] = {"arch": arch, "shape": (2, 2), "params": np_tree(jp),
                             "batch": batch, "S": SS, "steps": SSTEPS}
        serve_want[arch] = (jcfg, jm, jp, batch)

    ranks = {}

    def run_ranks():   # the ranks run beside JAX's own runs below
        for n in (2, 4):
            jobs = {"train": ("train_rank", (cases[n],)), "units": ("collective_rank", ())}
            if n == 4:
                jobs["serve"] = ("serve_rank", (serve_cases,))
            ranks[n] = D.spawn(R.world_rank, n, jobs, device="cpu", timeout=240)

    thread = threading.Thread(target=run_ranks)
    thread.start()
    for ref in refs.values():
        single(ref)

    serve_ref = {}
    for arch, (jcfg, jm, jp, batch) in serve_want.items():
        # each data rank's rows are a dispatch group of the reference's two
        logits, pc = jax.jit(jm.prefill)(jp, {k: jnp.asarray(v) for k, v in batch.items()})
        cache = {k: v.at[:, :, :ST].set(pc[k]) for k, v in jm.init_cache(SB, SS).items()}
        lgs, toks, step = [np.asarray(logits)], [], jax.jit(jm.decode_step)
        for i in range(SSTEPS):
            tok = jnp.argmax(logits[:, -1], axis=-1).astype(jnp.int32)[:, None]
            toks.append(np.asarray(tok))
            logits, cache = step(jp, cache, {"tokens": tok,
                                             "positions": jnp.full((SB,), ST + i, jnp.int32)})
            lgs.append(np.asarray(logits))
        serve_ref[arch] = (lgs, toks)

    # JAX's own step on a (2, 2) mesh with FSDP and EP, against its single device's
    jax_mesh = {}
    mesh = jax.make_mesh((2, 2), ("data", "model"), axis_types=(jax.sharding.AxisType.Auto,) * 2)
    rules = JA.single_pod_rules()
    for arch in T.JAX_MESHES:
        ref = refs[ref_key(arch, 2)]
        try:
            jcfg, jm, opt = ref["cfg"], ref["model"], ref["opt"]
            shapes = jax.eval_shape(lambda: ref["state0"])
            st_sh = JD.state_shardings(shapes, jcfg, mesh, rules, rules["batch"])
            g_sh = JD.grad_shardings(shapes["params"], jcfg, mesh, rules, rules["batch"])
            with mesh, JA.axis_rules(mesh, rules):
                step = jax.jit(JS.make_train_step(jm, opt, lambda s: jnp.float32(LR),
                                                  n_microbatches=MICRO, grad_shardings=g_sh))
                st = jax.device_put(jax.tree.map(jnp.asarray, ref["state0"]), st_sh)
                metrics = []
                for _ in range(STEPS):
                    st, m = step(st, ref["jbatch"])
                    metrics.append((float(m["loss"]), float(m["grad_norm"])))
            got, want = np_tree(st["params"]), ref["final"]["params"]
            start = ref["state0"]["params"]
            data_specs = sum("data" in str(s.spec) for s in jax.tree.leaves(st_sh["params"]))
            jax_mesh[arch] = {
                "data_specs": data_specs,
                "metrics": max(abs(a - b) / abs(b) for x, y in zip(metrics, ref["metrics"])
                               for a, b in zip(x, y)),
                "params": max(float(np.linalg.norm(a - b)) / max(
                    T.STEP_ABS * np.sqrt(b.size), T.STEP_REL * float(np.linalg.norm(b - c)))
                    for a, b, c in zip(jax.tree.leaves(got), jax.tree.leaves(want),
                                       jax.tree.leaves(start)))}
        except Exception as e:
            jax_mesh[arch] = f"{type(e).__name__}: {e}"[:400]
    thread.join()

    def rel(got, want):
        return float(np.linalg.norm(got - want) / (np.linalg.norm(want) + 1e-8 / T.GRAD_TOL))

    def excess(got, want):
        return float(np.max(np.abs(got - want) - (1e-5 + 1e-5 * np.abs(want))))

    res = {"cases": {}, "jax_mesh": jax_mesh, "serve": {},
           "units": {n: [r["units"] for r in ranks[n]] for n in (2, 4)}}
    for name, (arch, shape, zero) in T.CASES.items():
        ref, n = refs[ref_key(arch, shape[0])], shape[0] * shape[1]
        cfg = get_config(arch, smoke=True).replace(param_dtype="float32", fsdp=ref["cfg"].fsdp)
        pmesh = Mesh(shape, ("data", "model"))
        rs = [r["train"][name] for r in ranks[n]]
        grads = bridge.params_from_jax(ref["grads"])
        msh = model_shardings(grads, cfg, pmesh, single_pod_rules())
        gsh = shardings_for(grads, cfg, pmesh, single_pod_rules(), zero1=True) if zero else None
        s0 = bridge.train_state_from_jax(ref["state0"])
        s2 = bridge.train_state_from_jax(ref["final"])
        grad_err, step_err, alike = {}, {}, []
        data_cut = set()
        for rank, r in enumerate(rs):
            want = {"/".join(map(str, p)): t.numpy() for p, t in flatten(msh.take(grads, rank))}
            for k, g in r["grads"].items():
                grad_err[k] = max(grad_err.get(k, 0.0), rel(g, want[k]))
            w0, w2 = (bridge.shard_train_state(s, cfg, pmesh, rank, gsh) for s in (s0, s2))
            w0 = {"/".join(map(str, p)): t.numpy() for p, t in flatten(
                {"params": w0["params"], "opt": w0["opt"]})}
            w2 = {"/".join(map(str, p)): t.numpy() for p, t in flatten(
                {"params": w2["params"], "opt": w2["opt"]})}
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
            if any(rs[q]["grads"][k].size * shape[0] <= sizes[k] and
                   not np.array_equal(rs[q]["grads"][k], rs[q + shape[1]]["grads"][k])
                   for q in range(shape[1])):
                data_cut.add(k)
        res["cases"][name] = {
            "loss": [abs(r["loss"] - ref["loss"]) for r in rs],
            "grad_err": grad_err, "step_err": step_err, "alike": alike,
            "data_cut": sorted(data_cut),
            "metrics": max(abs(a - b) / abs(b) for r in rs for x, y in
                           zip(r["metrics"], ref["metrics"]) for a, b in zip(x, y))}
    for arch in T.SERVED:
        lgs, toks = serve_ref[arch]
        rs = [r["serve"][arch] for r in ranks[4]]
        out = {"logits": -1.0, "tokens": True, "ep": [r["ep"] for r in rs],
               "gathered": rs[0]["gathered"], "held": [r["held"] for r in rs]}
        for rank, r in enumerate(rs):
            rows = slice((rank // 2) * 2, (rank // 2) * 2 + 2)
            out["logits"] = max([out["logits"]] + [excess(a, b[rows])
                                                   for a, b in zip(r["logits"], lgs)])
            out["tokens"] &= all(np.array_equal(a, b[rows]) for a, b in zip(r["tokens"], toks))
        out["whole"] = int(sum(np.size(a) for a in jax.tree.leaves(serve_want[arch][2])))
        res["serve"][arch] = out
    print(json.dumps(res, default=str))
"""


def _case(runs, name):
    return runs["cases"][name]


@pytest.mark.parametrize("name", list(CASES))
def test_loss_and_gradient_blocks_match_jax(runs, name):
    """Each rank's loss, and its gradient block of every leaf (a block cut
    over the data axes summed over the data group by the gather's
    reduce-scatter or the experts' all-to-all, divided by its size) against
    its block of JAX's gradient."""
    r = _case(runs, name)
    assert max(r["loss"]) <= LOSS_TOL, r["loss"]
    bad = {k: v for k, v in r["grad_err"].items() if not v <= GRAD_TOL}
    assert not bad, bad
    assert len(r["grad_err"]) > 10


@pytest.mark.parametrize("name", list(CASES))
def test_blocks_over_the_data_axis_differ_and_replicated_ones_are_alike(runs, name):
    """The data axis cuts the FSDP leaves (every projection and the
    embeddings) or the experts, so two data ranks hold different blocks of
    them; the leaves no rank splits have the same gradient, bit for bit, on
    every rank."""
    r, arch = _case(runs, name), CASES[name][0]
    assert r["alike"] and all(ok for _, ok in r["alike"]), [k for k, ok in r["alike"] if not ok]
    cut = r["data_cut"]
    if arch == "phi3.5-moe-42b-a6.6b":
        assert {k.rsplit("/", 1)[1] for k in cut} == {"w1", "w2", "w3"}
        assert all("/moe/" in k for k in cut), cut
    else:
        for want in ("embed/tok", "embed/out", "layers/0/attn/wq", "layers/1/mlp/w2"):
            assert want in cut, (want, cut)


@pytest.mark.parametrize("name", list(CASES))
def test_fsdp_and_ep_train_steps_match_jax(runs, name):
    """Two steps of make_train_step on the mesh: each leaf of the rank's
    params and AdamW state (ZeRO-2's blocks where asked; a data-cut block's
    moments its own) against its block of JAX's, within the module's
    tolerance (the ratio is distance over tolerance); the losses and grad
    norms of both steps."""
    r = _case(runs, name)
    bad = {k: v for k, v in r["step_err"].items() if not v <= 1.0}
    assert not bad, bad
    assert any(k.startswith("opt/") for k in r["step_err"])
    assert r["metrics"] <= METRIC_TOL, r["metrics"]


@pytest.mark.parametrize("arch", SERVED)
def test_serving_on_a_2x2_mesh_matches_jax(runs, arch):
    """Prefill and 3 greedy decode steps on (2, 2): each rank's logits of
    its data rank's rows within 1e-5 of JAX's single-device run, the greedy
    tokens identical, and each rank holding under half of the whole params
    (FSDP over "data", TP over "model"), its embeddings among the gathered
    leaves, and the MoE archs' experts split over "data"."""
    r = runs["serve"][arch]
    assert r["logits"] <= 0, r
    assert r["tokens"], r
    assert max(r["held"]) < r["whole"] / 2, r
    assert "embed/tok" in r["gathered"], r
    if arch in ("phi3.5-moe-42b-a6.6b", "arctic-480b"):
        assert all(r["ep"]), r


@pytest.mark.parametrize("arch", JAX_MESHES)
def test_jax_train_step_on_a_2x2_mesh_with_fsdp_and_ep_matches_its_single_device_step(runs,
                                                                                     arch):
    err = runs["jax_mesh"][arch]
    assert isinstance(err, dict), err
    assert err["data_specs"] > 0
    assert err["metrics"] <= METRIC_TOL and err["params"] <= 1.0, err


@pytest.mark.parametrize("n", [2, 4])
def test_fsdp_gather_and_expert_all_to_all_backward(runs, n):
    """FSDPGather's backward is the reduce-scatter of the summed gradient;
    ExpertAllToAll's is the all-to-all back, and the way back inverts the
    way there."""
    for r in runs["units"][str(n)]:
        assert r["gather"] <= 1e-5 and r["to_experts"] <= 1e-6 and r["to_groups"] == 0, r


# ----------------------------------------------------------------- in process

@pytest.mark.parametrize("arch, shape", [("phi3.5-moe-42b-a6.6b", (2, 1)),
                                         ("qwen1.5-32b", (2, 1)), ("qwen1.5-32b", (2, 2))])
def test_trainer_checkpoints_the_blocks_of_states_cut_over_the_data_axis(tmp_path, arch,
                                                                          shape):
    """The Trainer of a state that FSDP or the experts cut over the data
    axis checkpoints by the train state's shardings: it runs ZeRO-2 over the
    data axis, and each leaf of the state it draws is its block under them
    (params, AdamW's moments as ZeRO-1 blocks), and the data axis cuts some
    of them."""
    from repro_torch.checkpoint.checkpointer import Checkpointer
    from repro_torch.data.pipeline import DataConfig, TokenPipeline
    from repro_torch.train.trainer import Trainer, TrainerConfig
    from repro_torch.tree import flatten
    cfg = get_config(arch, smoke=True).replace(fsdp=get_config(arch).fsdp)
    pipe = TokenPipeline(DataConfig(vocab_size=cfg.vocab_size, seq_len=16, global_batch=4))
    with fake_group(shape[0] * shape[1]):
        model = build_model(cfg, device="meta",
                            mesh=make_mesh(shape, ("data", "model"), device="cpu"))
        assert model.dp is not None
        t = Trainer(model, make_optimizer("adamw"), pipe, Checkpointer(str(tmp_path)),
                    TrainerConfig())
        assert t.grad_shardings is not None
        state = train_state(model.init_params(torch.Generator()), t.opt, t.grad_shardings,
                            model.split)
        cut = 0
        for (path, leaf), b in zip(flatten(state), t.shardings.index(state, 0)):
            want = (0,) if b is None else tuple(s.stop - s.start for s in b)
            assert tuple(leaf.shape) == want, (path, tuple(leaf.shape), want)
            cut += b is not None and want != t.shardings.full_shape(path)
        assert cut > 0


@pytest.mark.parametrize("shape", [(2, 1), (2, 2)])
def test_adafactor_state_of_leaves_cut_over_the_data_axis_is_their_blocks(shape):
    """arctic-480b's Adafactor on its FSDP and expert leaves: each statistic
    the state holds is the rank's block of the whole leaf's (`vr` cut where
    the rows are, `vc` where the columns are, `state_shardings`), with and
    without ZeRO-1, and the train step builds."""
    from repro_torch.sharding.axes import rules_for
    from repro_torch.sharding.rules import shardings_for, state_shardings
    from repro_torch.tree import flatten
    cfg = get_config("arctic-480b", smoke=True).replace(fsdp=True)
    whole = build_model(cfg, device="meta").init_params(torch.Generator())
    opt = make_optimizer("adafactor")
    with fake_group(shape[0] * shape[1]):
        mesh = make_mesh(shape, ("data", "model"), device="cpu")
        model = build_model(cfg, device="meta", mesh=mesh)
        params = model.init_params(torch.Generator())
        for zero in (False, True):
            gsh = shardings_for(whole, cfg, mesh, rules_for(mesh), zero1=True) if zero else None
            sh = state_shardings(train_state(whole, opt), cfg, mesh, rules_for(mesh), gsh)
            state = train_state(params, opt, gsh, model.split)
            cut = 0
            for (path, leaf), b in zip(flatten(state), sh.index(state, 0)):
                if path[:2] != ("opt", "s"):
                    continue
                want = (0,) if b is None else tuple(s.stop - s.start for s in b)
                assert tuple(leaf.shape) == want, (path, tuple(leaf.shape), want)
                cut += b is not None and want != sh.full_shape(path)
            assert cut > 0
            assert make_train_step(model, opt, lambda s: 1e-3, grad_shardings=gsh) is not None

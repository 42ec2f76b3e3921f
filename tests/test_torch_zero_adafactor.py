"""Adafactor and checkpoints on every mesh: ZeRO-1 of Adafactor's state,
Adafactor on FSDP and expert leaves (optim/optimizers.py's units and cuts,
train/steps.py's ZeRO-2 path), the train state's shardings
(sharding/rules.py::state_shardings), bridge.shard_train_state, the
checkpointer's sharded save and resharded restore, and the Trainer on a
(dp, tp) mesh, against the JAX package on the CPU.

One subprocess runs JAX with four host devices
(`--xla_force_host_platform_device_count=4`, Auto axes) and, in a thread
beside JAX's own runs, the port's ranks: gloo processes on the CPU started
by `repro_torch.distributed.spawn`, one spawn per world size (2 and 4)
serving every case; the rank bodies are in tests/_torch_zero_adafactor_ranks.py
and tests/_torch_tp_ranks.py.

Training, all fp32 SMOKE configs on the plain kernels, Adafactor, from the
same JAX-initialised train state handed over by the bridge, 4 x 16 tokens
(numpy, seeded), 2 microbatches, 2 steps at a constant learning rate of
1e-2, held to JAX's single-device `make_train_step` and `jax.value_and_grad`
of its loss with the bounds of tests/test_torch_tp_train.py: the loss within
1e-5; each rank's gradient block within 1e-4 relative L2 of its block of
JAX's; each block of the params and of Adafactor's statistics (`vr`, `vc`,
`v`: the rank's block of JAX's whole statistic) within a hundredth of what
the two steps moved it. Cases: arctic SMOKE with FSDP (its published
`fsdp`) on (2, 1) with ZeRO-2 and on (2, 2) with and without (FSDP, EP,
expert-TP, the dense residual); llama3-8b SMOKE on (2, 1) and (2, 2) with
ZeRO-2; phi3.5-moe SMOKE on (2, 2) with ZeRO-2 (experts over "data"). The
MoE references dispatch as many groups as the mesh's data axis. JAX's own
sharded Adafactor step (the dry-run's state and grad shardings) on (2, 2)
is held to its single-device step at the same bound.

Checkpoints: a sharded save of step 1 from (1, 2) with Adafactor (arctic
SMOKE), from (2, 2) with ZeRO-2 (llama3-8b SMOKE, AdamW and Adafactor),
and from phi's (EP, Adafactor) and qwen's (FSDP, AdamW) (2, 2) states
with ZeRO-2: its manifest and arrays equal, bit for bit, a one-process save
of the ranks' blocks put together; restored on the same mesh, the state
and the next step equal the straight run's bit for bit; restored on
another mesh shape ((2, 1) for the first, (4, 1) for the rest; 8 x 16
tokens a batch) it equals
the rank's cut of the checkpoint read whole, and so does a step from it;
restored in one process it equals the blocks put together. The Trainer
(3 steps, a checkpoint every 2), crashed at step 2 and restarted, ends bit
for bit where a straight run ends: arctic SMOKE on (1, 2) with Adafactor;
on (2, 2), where the Trainer runs ZeRO-2, llama3-8b SMOKE (AdamW and
Adafactor), phi3.5-moe SMOKE with Adafactor (EP) and qwen1.5-32b SMOKE
with AdamW (FSDP).
"""
import pytest

import _torch_subproc as subproc

# name -> (arch, mesh shape, ZeRO-2)
CASES = {
    "arctic-480b/2x1-zero2": ("arctic-480b", (2, 1), True),
    "arctic-480b/2x2": ("arctic-480b", (2, 2), False),
    "arctic-480b/2x2-zero2": ("arctic-480b", (2, 2), True),
    "llama3-8b/2x1-zero2": ("llama3-8b", (2, 1), True),
    "llama3-8b/2x2-zero2": ("llama3-8b", (2, 2), True),
    "phi3.5-moe-42b-a6.6b/2x2-zero2": ("phi3.5-moe-42b-a6.6b", (2, 2), True),
}
JAX_MESHES = ["arctic-480b/2x2-zero2", "llama3-8b/2x2-zero2"]
# name -> (arch, optimizer, mesh shape, ZeRO-2, another mesh shape, its ZeRO-2)
CKPT = {
    "arctic-480b/1x2-adafactor": ("arctic-480b", "adafactor", (1, 2), False, (2, 1), True),
    "llama3-8b/2x2-zero2-adamw": ("llama3-8b", "adamw", (2, 2), True, (4, 1), True),
    "llama3-8b/2x2-zero2-adafactor": ("llama3-8b", "adafactor", (2, 2), True, (4, 1), True),
    "phi3.5-moe-42b-a6.6b/2x2-zero2-adafactor": ("phi3.5-moe-42b-a6.6b", "adafactor", (2, 2),
                                                 True, (4, 1), True),
    "qwen1.5-32b/2x2-zero2-adamw": ("qwen1.5-32b", "adamw", (2, 2), True, (4, 1), True),
}
# name -> (arch, optimizer, mesh shape): the Trainer crashed and restarted
# (ZeRO-2 over "data" wherever the mesh has a data axis)
TRAINER = {
    "arctic-480b/1x2-adafactor": ("arctic-480b", "adafactor", (1, 2)),
    "llama3-8b/2x2-zero2-adamw": ("llama3-8b", "adamw", (2, 2)),
    "llama3-8b/2x2-zero2-adafactor": ("llama3-8b", "adafactor", (2, 2)),
    "phi3.5-moe-42b-a6.6b/2x2-zero2-adafactor": ("phi3.5-moe-42b-a6.6b", "adafactor", (2, 2)),
    "qwen1.5-32b/2x2-zero2-adamw": ("qwen1.5-32b", "adamw", (2, 2)),
}
LOSS_TOL, GRAD_TOL, STEP_REL, STEP_ABS, METRIC_TOL = 1e-5, 1e-4, 1e-2, 1e-5, 1e-5


@pytest.fixture(scope="module")
def runs():
    return subproc.run(SCRIPT, devices=4)


SCRIPT = """
    import json
    import os
    import shutil
    import tempfile
    import threading
    import numpy as np
    import jax, jax.numpy as jnp
    import torch
    from repro.configs import get_config as jget
    from repro.models import build_model as jbuild
    from repro.optim.optimizers import make_optimizer as jopt
    from repro.sharding import axes as JA
    from repro.train import steps as JS
    from repro_torch import bridge
    from repro_torch import distributed as D
    from repro_torch.checkpoint.checkpointer import Checkpointer
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models import build_model
    from repro_torch.optim.optimizers import make_optimizer
    from repro_torch.sharding.axes import single_pod_rules
    from repro_torch.sharding.rules import model_shardings, shardings_for, state_shardings
    from repro_torch.train.steps import train_state
    from repro_torch.tree import flatten, leaves, tree_map, unflatten_like
    import test_torch_zero_adafactor as T
    import _torch_zero_adafactor_ranks as R
    jax.devices()                 # the four host devices, before the dry-run's flags
    from repro.launch import dryrun as JD

    B, T_, LR, STEPS, MICRO = 4, 16, 1e-2, 2, 2
    rng = np.random.default_rng(17)

    def np_tree(t):
        return jax.tree.map(np.asarray, t)

    def jcfg_of(arch):
        return jget(arch, smoke=True).replace(param_dtype="float32", fsdp=jget(arch).fsdp,
                                               optimizer="adafactor")

    def batch_of(vocab, rows=B):
        return {"tokens": rng.integers(0, vocab, (rows, T_)).astype(np.int32),
                "targets": rng.integers(0, vocab, (rows, T_)).astype(np.int32)}

    def setup(arch, groups):
        jcfg = jcfg_of(arch)
        jm = jbuild(jcfg, n_groups=groups)
        opt = jopt("adafactor")
        state0 = JS.make_init_state(jm, opt)(jax.random.PRNGKey(0))
        batch = batch_of(jcfg.vocab_size)
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
            "config": {"optimizer": "adafactor"}, "state": ref["state0"], "batch": ref["batch"],
            "lr": LR, "steps": STEPS, "micro": MICRO}
    ckpt, ckpt_batches = {2: {}, 4: {}}, {}
    for name, (arch, opt, shape, zero, other, other_zero) in T.CKPT.items():
        vocab = jget(arch, smoke=True).vocab_size
        # 8 rows: 2 microbatches over the 4 data ranks of (4, 1)
        ckpt_batches[name] = [batch_of(vocab, 8), batch_of(vocab, 8)]
        ckpt[shape[0] * shape[1]][name] = {
            "arch": arch, "opt": opt, "fsdp": jget(arch).fsdp, "shape": shape, "zero": zero,
            "other": other, "other_zero": other_zero, "batches": ckpt_batches[name]}
    trainer = {2: {}, 4: {}}
    for name, (arch, opt, shape) in T.TRAINER.items():
        trainer[shape[0] * shape[1]][name] = {"arch": arch, "opt": opt, "fsdp": jget(arch).fsdp,
                                              "shape": shape}
    ranks = {}
    tmp = tempfile.mkdtemp(prefix="zero-adafactor-")

    def run_ranks():   # the ranks run beside JAX's own runs below
        for n in (2, 4):
            jobs = {"train": ("train_rank", (cases[n],)),
                    "ckpt": ("ckpt_rank", (ckpt[n], tmp + "/ckpt"))}
            jobs["trainer"] = ("trainer_crash_rank", (trainer[n], tmp + "/trainer"))
            ranks[n] = D.spawn(R.world_rank, n, jobs, device="cpu", timeout=240)

    thread = threading.Thread(target=run_ranks)
    thread.start()
    for ref in refs.values():
        single(ref)

    # JAX's own Adafactor step on a (2, 2) mesh, against its single device's
    jax_mesh = {}
    mesh = jax.make_mesh((2, 2), ("data", "model"), axis_types=(jax.sharding.AxisType.Auto,) * 2)
    rules = JA.single_pod_rules()
    for name in T.JAX_MESHES:
        ref = refs[ref_key(T.CASES[name][0], 2)]
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
            got, want, start = np_tree(st), ref["final"], ref["state0"]
            jax_mesh[name] = {
                "metrics": max(abs(a - b) / abs(b) for x, y in zip(metrics, ref["metrics"])
                               for a, b in zip(x, y)),
                "state": max(float(np.linalg.norm(a - b)) / max(
                    T.STEP_ABS * np.sqrt(b.size), T.STEP_REL * float(np.linalg.norm(b - c)))
                    for a, b, c in zip(jax.tree.leaves(got), jax.tree.leaves(want),
                                       jax.tree.leaves(start)))}
        except Exception as e:
            jax_mesh[name] = f"{type(e).__name__}: {e}"[:400]
    thread.join()

    def rel(got, want):
        return float(np.linalg.norm(got - want) / (np.linalg.norm(want) + 1e-8 / T.GRAD_TOL))

    res = {"cases": {}, "jax_mesh": jax_mesh, "ckpt": {},
           "trainer": {name: [r["trainer"][name] for r in ranks[shape[0] * shape[1]]]
                       for name, (_, _, shape) in T.TRAINER.items()}}
    for name, (arch, shape, zero) in T.CASES.items():
        ref, n = refs[ref_key(arch, shape[0])], shape[0] * shape[1]
        cfg = get_config(arch, smoke=True).replace(param_dtype="float32", fsdp=ref["cfg"].fsdp,
                                                   optimizer="adafactor")
        pmesh = Mesh(shape, ("data", "model"))
        rs = [r["train"][name] for r in ranks[n]]
        grads = bridge.params_from_jax(ref["grads"])
        msh = model_shardings(grads, cfg, pmesh, single_pod_rules())
        gsh = shardings_for(grads, cfg, pmesh, single_pod_rules(), zero1=True) if zero else None
        s0 = bridge.train_state_from_jax(ref["state0"])
        s2 = bridge.train_state_from_jax(ref["final"])
        grad_err, step_err, empty = {}, {}, 0
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
                assert got.shape == want2.shape, (name, rank, k, got.shape, want2.shape)
                empty += got.size == 0
                tol = max(T.STEP_ABS * np.sqrt(max(got.size, 1)),
                          T.STEP_REL * float(np.linalg.norm(want2 - start)))
                d = float(np.linalg.norm(got - want2))
                step_err[k] = max(step_err.get(k, 0.0), d / tol if tol else d)
        res["cases"][name] = {
            "loss": [abs(r["loss"] - ref["loss"]) for r in rs],
            "grad_err": grad_err, "step_err": step_err, "empty": empty,
            "metrics": max(abs(a - b) / abs(b) for r in rs for x, y in
                           zip(r["metrics"], ref["metrics"]) for a, b in zip(x, y))}

    # checkpoints: the ranks' save against one process's save of their blocks
    for name, (arch, opt, shape, zero, other, other_zero) in T.CKPT.items():
        n = shape[0] * shape[1]
        rs = [r["ckpt"][name] for r in ranks[n]]
        c = {"arch": arch, "opt": opt, "fsdp": jget(arch).fsdp}
        cfg = R.case_cfg(c)
        pmesh = Mesh(shape, ("data", "model"))
        meta = build_model(cfg, device="meta").init_params(torch.Generator())
        gsh = shardings_for(meta, cfg, pmesh, single_pod_rules(), zero1=True) if zero else None
        ssh = state_shardings(train_state(meta, make_optimizer(opt)), cfg, pmesh,
                              single_pod_rules(), gsh)
        like = R.whole_state(cfg, "cpu")
        paths = ["/".join(map(str, p)) for p, _ in flatten(like)]
        parts = [unflatten_like(like, [r["saved"][k] for k in paths]) for r in rs]
        whole = bridge.assemble(parts, ssh)
        mine = os.path.join(tmp, "one", name)
        Checkpointer(mine).save(1, tree_map(torch.from_numpy, whole), blocking=True)
        theirs = os.path.join(tmp, "ckpt", name)
        man = [json.load(open(os.path.join(d, "step_0000000001", "manifest.json")))["leaves"]
               for d in (mine, theirs)]
        files = [k for k in man[0] if not np.array_equal(
            np.load(os.path.join(mine, "step_0000000001", man[0][k]["file"])),
            np.load(os.path.join(theirs, "step_0000000001", man[1][k]["file"])))]
        read, stepped = R.one_process(c, theirs, ckpt_batches[name][1])
        _, stepped_mine = R.one_process(c, mine, ckpt_batches[name][1])
        want_read = dict(zip(paths, leaves(whole)))
        res["ckpt"][name] = {
            "manifest": man[0] == man[1], "arrays": files, "n_leaves": len(man[0]),
            "restored": all(np.array_equal(r["restored"][k], r["saved"][k]) for r in rs
                            for k in r["saved"]),
            "resumed": all(np.array_equal(r["resumed"][k], r["straight"][k]) for r in rs
                           for k in r["straight"]),
            "moved": any(not np.array_equal(r["straight"][k], r["saved"][k]) for r in rs
                         for k in r["saved"] if k.startswith("params/")),
            "other_restored": [r["other_restored"] for r in rs],
            "other_step": [r["other_step"] for r in rs],
            "one_process": all(np.array_equal(read[k], want_read[k]) for k in paths),
            "one_process_step": all(np.array_equal(a, stepped_mine[k])
                                    for k, a in stepped.items()),
            "held": [sum(v.size for k, v in r["saved"].items() if k.startswith("opt/"))
                     for r in rs],
            "whole_opt": sum(np.size(v) for k, v in want_read.items() if k.startswith("opt/"))}
    shutil.rmtree(tmp, ignore_errors=True)
    print(json.dumps(res, default=str))
"""


@pytest.mark.parametrize("name", list(CASES))
def test_adafactor_loss_and_gradient_blocks_match_jax(runs, name):
    r = runs["cases"][name]
    assert max(r["loss"]) <= LOSS_TOL, r["loss"]
    bad = {k: v for k, v in r["grad_err"].items() if not v <= GRAD_TOL}
    assert not bad, bad
    assert len(r["grad_err"]) > 10


@pytest.mark.parametrize("name", list(CASES))
def test_adafactor_steps_on_every_cut_match_jax(runs, name):
    """Two Adafactor steps on the mesh: each rank's block of every param and
    of every statistic (`vr`, `vc`, `v`; ZeRO-1's blocks, empty for a layer
    another rank owns) against its block of JAX's single-device state,
    within a hundredth of the update (the ratio is distance over
    tolerance); the losses and grad norms of both steps."""
    r = runs["cases"][name]
    bad = {k: v for k, v in r["step_err"].items() if not v <= 1.0}
    assert not bad, bad
    stats = {k.rsplit("/", 1)[1] for k in r["step_err"] if k.startswith("opt/s/")}
    assert stats == {"vr", "vc", "v"}, stats
    assert r["metrics"] <= METRIC_TOL, r["metrics"]
    if CASES[name][2]:   # ZeRO-1 over the data axis: some layer is another rank's
        assert r["empty"] > 0


@pytest.mark.parametrize("name", JAX_MESHES)
def test_jax_adafactor_step_on_a_2x2_mesh_matches_its_single_device_step(runs, name):
    """Held as the port's steps are: params and statistics within a
    hundredth of their update, the metrics within 1e-5."""
    err = runs["jax_mesh"][name]
    assert isinstance(err, dict), err
    assert err["metrics"] <= METRIC_TOL and err["state"] <= 1.0, err


@pytest.mark.parametrize("name", list(CKPT))
def test_sharded_save_writes_what_one_process_writes(runs, name):
    """The ranks' save of step 1: the same manifest (keys, shapes, dtypes)
    and bit-identical arrays as one process's save of their blocks put
    together; ZeRO-1's and the data axis's blocks of the optimizer state
    are less than the whole on each rank."""
    r = runs["ckpt"][name]
    assert r["manifest"] and r["arrays"] == [] and r["n_leaves"] > 10, r
    if CKPT[name][3]:
        assert max(r["held"]) < r["whole_opt"], r


@pytest.mark.parametrize("name", list(CKPT))
def test_restore_on_the_same_mesh_resumes_bit_for_bit(runs, name):
    """Restored on the mesh that saved it, each rank's state is the saved
    blocks, and the next step equals the straight run's, bit for bit."""
    r = runs["ckpt"][name]
    assert r["restored"] and r["resumed"] and r["moved"], r


@pytest.mark.parametrize("name", list(CKPT))
def test_restore_on_another_mesh_and_in_one_process_is_bit_exact(runs, name):
    """Restored on another mesh shape, each rank's blocks are its cut of the
    checkpoint read whole, and a step from either is the same; restored in
    one process, the state is the ranks' blocks put together, and a step
    runs from it as from one process's own save."""
    r = runs["ckpt"][name]
    assert all(r["other_restored"]) and all(r["other_step"]), r
    assert r["one_process"] and r["one_process_step"], r


@pytest.mark.parametrize("name", list(TRAINER))
def test_trainer_resumes_after_a_crash_bit_for_bit(runs, name):
    """The Trainer on a mesh (TP with Adafactor; (2, 2), where it runs
    ZeRO-2: AdamW and Adafactor, EP and FSDP over "data"), crashed before step 2 and
    restarted from step 2's checkpoint: every rank's final blocks equal the
    straight run's, bit for bit, and the ranks hold blocks of the optimizer
    state."""
    rs = runs["trainer"][name]
    assert all(r["equal"] for r in rs) and all(r["start"] == 2 for r in rs), rs
    assert all(r["cut"] > 0 for r in rs), rs

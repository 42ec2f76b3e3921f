"""Tensor-parallel training of the port over the "model" axis (the
differentiable collectives of models/tensor_parallel.py, the vocab-parallel
loss of models/layers.py, the TP loss of dense.py and moe.py, registry's TP
loss, train/steps.py on (1, n) and (dp, tp) meshes with and without ZeRO-2,
Adafactor on split leaves in optim/optimizers.py, sharding/rules.py's local
ZeRO blocks, bridge.shard_train_state) against the JAX package, on the CPU.

One subprocess runs JAX with four host devices
(`--xla_force_host_platform_device_count=4`, Auto axes) and, in a thread
beside JAX's own runs, the port's ranks: gloo processes on the CPU started
by `repro_torch.distributed.spawn`, one spawn per world size (2 and 4)
serving every case; the rank bodies are in tests/_torch_tp_ranks.py. Every
input comes from numpy with a seed; both sides run fp32 on the plain
kernels, from the same JAX-initialised train state handed over by the
bridge, 4 x 16 tokens, 2 microbatches, a constant learning rate of 1e-2.

Cases: llama3-8b SMOKE at n = 2 and 4 (at 4, k/v gathered by columns),
qwen1.5-32b SMOKE at n = 4 (q gathered, `out_cols`, QKV bias), phi3.5-moe
SMOKE at n = 2 (expert-TP, the router's gradient), arctic SMOKE at n = 2
(Adafactor on split leaves, the dense residual), internvl2 SMOKE at n = 2
(patch embeddings), and llama3-8b and phi3.5-moe SMOKE on a (2, 2) mesh,
plain data parallelism and ZeRO-2 (phi's
single-device reference with 2 MoE dispatch groups, as the ranks' data
groups give them; SMOKE turns the FSDP archs' FSDP off).

What is compared, against JAX's single-device `make_train_step` and
`jax.value_and_grad` of its loss on the same state and batch:
  * the loss at the step-0 params: within 1e-5 absolute (fp32 sums in
    another order, partial sums added across the ranks);
  * each rank's gradient block against its block of JAX's gradient: 1e-4
    relative L2 per leaf (plus 1e-8 absolute, for a leaf whose gradient is
    zero), the router's included;
  * each leaf that no rank splits over "model": its gradient equal on
    every rank, bit for bit;
  * after 2 steps, each leaf of the rank's params and optimizer state
    against its block of JAX's: the L2 distance within 1e-5 x sqrt(size)
    or a hundredth of the L2 norm of what the two steps moved JAX's leaf
    (a state starts at zero, so its own norm), whichever is larger; the
    steps' losses and grad norms within 1e-5 relative. AdamW's first
    update is about lr x sign(g), so an entry whose gradient is near zero
    moves by up to 2 lr on a rounding of g: the L2 tolerance absorbs a few
    such entries, the measured worst is about a quarter of it.

JAX's own step on (1, n) and (2, 2) meshes with the dry-run's
state and grad shardings (ZeRO-2) against its single-device step, held as
the port's steps are. The port's ZeRO-2 blocks on a (2, 2) mesh: the
global block equal to JAX's `devices_indices_map` of its grad shardings,
and the local block (`Shardings.local_index`) that block's place inside
the rank's "model" block.
"""
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.launch.mesh import Mesh
from repro_torch.models import build_model
from repro_torch.optim.optimizers import make_optimizer
from repro_torch.sharding.axes import single_pod_rules
from repro_torch.sharding.rules import shardings_for
from repro_torch.train.steps import make_train_step, train_state

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT = 300
# name -> (arch, mesh shape, ZeRO-2)
CASES = {
    "llama3-8b/1x2": ("llama3-8b", (1, 2), False),
    "llama3-8b/1x4": ("llama3-8b", (1, 4), False),
    "qwen1.5-32b/1x4": ("qwen1.5-32b", (1, 4), False),
    "phi3.5-moe-42b-a6.6b/1x2": ("phi3.5-moe-42b-a6.6b", (1, 2), False),
    "arctic-480b/1x2": ("arctic-480b", (1, 2), False),
    "internvl2-76b/1x2": ("internvl2-76b", (1, 2), False),
    "llama3-8b/2x2": ("llama3-8b", (2, 2), False),
    "llama3-8b/2x2-zero2": ("llama3-8b", (2, 2), True),
    "phi3.5-moe-42b-a6.6b/2x2": ("phi3.5-moe-42b-a6.6b", (2, 2), False),
    "phi3.5-moe-42b-a6.6b/2x2-zero2": ("phi3.5-moe-42b-a6.6b", (2, 2), True),
}
JAX_MESHES = {"llama3-8b/1x4": ("llama3-8b", (1, 4)), "llama3-8b/2x2": ("llama3-8b", (2, 2)),
              "phi3.5-moe-42b-a6.6b/1x2": ("phi3.5-moe-42b-a6.6b", (1, 2)),
              "phi3.5-moe-42b-a6.6b/2x2": ("phi3.5-moe-42b-a6.6b", (2, 2))}
ZERO_SPEC_ARCHS = ["llama3-8b", "phi3.5-moe-42b-a6.6b"]
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
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models import build_model
    from repro_torch.sharding.axes import single_pod_rules
    from repro_torch.sharding.rules import block, coordinate, model_shardings, shardings_for
    from repro_torch.tree import flatten
    import test_torch_tp_train as T
    import _torch_tp_ranks as R
    jax.devices()                 # the four host devices, before the dry-run's flags
    from repro.launch import dryrun as JD

    B, T_, LR, STEPS, MICRO = 4, 16, 1e-2, 2, 2
    rng = np.random.default_rng(11)

    def names(path):
        return tuple(getattr(k, "key", getattr(k, "name", None)) for k in path)

    def np_tree(t):
        return jax.tree.map(np.asarray, t)

    def setup(arch, groups):
        # JAX's state 0 from PRNGKey(0) and a batch: what the ranks start from
        jcfg = jget(arch, smoke=True).replace(param_dtype="float32")
        jm = jbuild(jcfg, n_groups=groups)
        opt = jopt(jcfg.optimizer)
        state0 = JS.make_init_state(jm, opt)(jax.random.PRNGKey(0))
        batch = {"tokens": rng.integers(0, jcfg.vocab_size, (B, T_)).astype(np.int32),
                 "targets": rng.integers(0, jcfg.vocab_size, (B, T_)).astype(np.int32)}
        if jcfg.family == "vlm":
            batch["patch_embeds"] = rng.standard_normal(
                (B, jcfg.vlm.n_patches, jcfg.d_model)).astype(np.float32)
        jb = {k: jnp.asarray(v) for k, v in batch.items()}
        return dict(cfg=jcfg, model=jm, opt=opt, batch=batch, jbatch=jb, state0_j=state0,
                    state0=np_tree(state0))

    def single(ref):
        # JAX's single-device loss and gradient on the whole batch, and STEPS steps
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
        cases[shape[0] * shape[1]][name] = {"arch": arch, "shape": shape, "zero": zero,
                                            "state": ref["state0"], "batch": ref["batch"],
                                            "lr": LR, "steps": STEPS, "micro": MICRO}
    ranks = {}
    tmp = tempfile.mkdtemp(prefix="tp-trainer-")

    def run_ranks():   # the ranks run beside JAX's own runs below
        for n in (2, 4):
            jobs = {"train": ("train_rank", (cases[n],)), "units": ("collective_rank", ())}
            if n == 2:
                jobs["trainer"] = ("trainer_rank", (tmp + "/ranks",))
            ranks[n] = D.spawn(R.world_rank, n, jobs, device="cpu", timeout=240)

    thread = threading.Thread(target=run_ranks)
    thread.start()
    for ref in refs.values():
        single(ref)

    # JAX's own step on a mesh with the dry-run's shardings, against its single device's
    jax_mesh = {}
    for name, (arch, shape) in T.JAX_MESHES.items():
        ref = refs[ref_key(arch, shape[0])]
        mesh = jax.make_mesh(shape, ("data", "model"),
                             axis_types=(jax.sharding.AxisType.Auto,) * 2)
        rules = JA.single_pod_rules()
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
            jax_mesh[name] = {
                "metrics": max(abs(a - b) / abs(b) for x, y in zip(metrics, ref["metrics"])
                               for a, b in zip(x, y)),
                "params": max(float(np.linalg.norm(a - b)) / max(
                    T.STEP_ABS * np.sqrt(b.size), T.STEP_REL * float(np.linalg.norm(b - c)))
                    for a, b, c in zip(jax.tree.leaves(got), jax.tree.leaves(want),
                                       jax.tree.leaves(start)))}
        except Exception as e:
            jax_mesh[name] = f"{type(e).__name__}: {e}"[:400]

    # the port's ZeRO-2 blocks on (2, 2) against JAX's grad shardings
    zero_blocks = {}
    jmesh = jax.make_mesh((2, 2), ("data", "model"), axis_types=(jax.sharding.AxisType.Auto,) * 2)
    mesh = Mesh((2, 2), ("data", "model"))
    for arch in T.ZERO_SPEC_ARCHS:
        for smoke in (True, False):
            jcfg, cfg = jget(arch, smoke=smoke), get_config(arch, smoke=smoke)
            jp = jax.eval_shape(jbuild(jcfg).init_params, jax.random.PRNGKey(0))
            rules, jrules = single_pod_rules(), JA.single_pod_rules()
            jsh = JD.grad_shardings(jp, jcfg, jmesh, jrules, jrules["batch"])
            bad, split_inside = [], 0
            params = build_model(cfg, device="meta").init_params(torch.Generator())
            sh = shardings_for(params, cfg, mesh, rules, zero1=True)
            held = sh.without(("pod", "data"))
            for (path, leaf), ns in zip(jax.tree_util.tree_flatten_with_path(jp)[0],
                                        jax.tree.leaves(jsh)):
                p = names(path)
                for dev, idx in ns.devices_indices_map(leaf.shape).items():
                    i, j = next(zip(*np.nonzero(jmesh.devices == dev)))
                    rank = int(i) * 2 + int(j)
                    want = [[s.start or 0, n if s.stop is None else s.stop]
                            for s, n in zip(idx, leaf.shape)]
                    coord = coordinate(mesh, rank)
                    glob = block(leaf.shape, sh.specs[p], mesh, coord)
                    model_b = block(leaf.shape, held.specs[p], mesh, coord)
                    if [[s.start, s.stop] for s in glob] != want:
                        bad.append(["global", p, rank, want])
                    # the port keeps the layers as a list: ask it for one item
                    # (layer 0, or the rank's first owned one) by its port path
                    depth = 1 if p[0] == "layers" else 0
                    item = glob[0].start if depth else None
                    ppath = (p[0], item) + p[1:] if depth else p
                    loc = sh.local_block_of(ppath, rank, held=held)
                    inner_g, inner_m = glob[depth:], model_b[depth:]
                    exp = [[g.start - m.start, g.stop - m.start] for g, m in zip(inner_g, inner_m)]
                    if loc is None or [[s.start, s.stop] for s in loc] != exp:
                        bad.append(["local", p, rank, None if loc is None else
                                    [[s.start, s.stop] for s in loc], exp])
                    split_inside += any((m.stop - m.start) < n for m, n in
                                        zip(inner_m, leaf.shape[depth:]))
            zero_blocks[f"{arch}/{'smoke' if smoke else 'full'}"] = {
                "bad": bad[:5], "inside_model_blocks": split_inside}
    thread.join()

    def rel(got, want):
        return float(np.linalg.norm(got - want) / (np.linalg.norm(want) + 1e-8 / GRAD_TOL))

    # the Trainer: one process, then the ranks' run and checkpoint
    single = R.trainer_run("cpu", tmp + "/single")
    from repro_torch.checkpoint.checkpointer import Checkpointer
    from repro_torch.optim.optimizers import make_optimizer
    from repro_torch.train.steps import train_state
    tcfg = get_config("llama3-8b", smoke=True).replace(param_dtype="float32")
    like = train_state(build_model(tcfg, device="cpu").init_params(torch.Generator()),
                       make_optimizer("adamw"))
    Checkpointer(tmp + "/ranks").restore(like)
    saved = {"/".join(map(str, p)): t.float().numpy() for p, t in flatten(like)}
    p0 = {"params/" + "/".join(map(str, p)): t.numpy() for p, t in flatten(
        build_model(tcfg, device="cpu").init_params(torch.Generator().manual_seed(5)))}
    tsh = model_shardings(like["params"], tcfg, Mesh((1, 2), ("data", "model")),
                          single_pod_rules())
    trainer = {"steps": [], "saved": []}
    for rank, r in enumerate(ranks[2]):
        for k, got in r["trainer"].items():
            path = tuple(int(x) if x.isdigit() else x for x in k.split("/"))
            inner = path[1:] if path[0] == "params" else \
                path[2:] if path[:2] in (("opt", "m"), ("opt", "v")) else None
            b = tsh.block_of(inner, rank) if inner is not None else ()
            want = single[k][b]
            trainer["saved"].append([k, bool(np.array_equal(got, saved[k][b]))])
            moved = want - p0[k][b] if k in p0 else want
            tol = max(T.STEP_ABS * np.sqrt(max(got.size, 1)),
                      T.STEP_REL * float(np.linalg.norm(moved)))
            trainer["steps"].append([k, float(np.linalg.norm(got - want)) / tol])
    shutil.rmtree(tmp, ignore_errors=True)

    GRAD_TOL = T.GRAD_TOL
    res = {"trainer": trainer, "cases": {}, "jax_mesh": jax_mesh, "zero_blocks": zero_blocks,
           "units": {n: [r["units"] for r in ranks[n]] for n in (2, 4)}}
    for name, (arch, shape, zero) in T.CASES.items():
        ref, n = refs[ref_key(arch, shape[0])], shape[0] * shape[1]
        cfg = get_config(arch, smoke=True).replace(param_dtype="float32")
        pmesh = Mesh(shape, ("data", "model"))
        rs = [r["train"][name] for r in ranks[n]]
        grads = bridge.params_from_jax(ref["grads"])
        msh = model_shardings(grads, cfg, pmesh, single_pod_rules())
        gsh = shardings_for(grads, cfg, pmesh, single_pod_rules(), zero1=True) if zero else None
        s0 = bridge.train_state_from_jax(ref["state0"])
        s2 = bridge.train_state_from_jax(ref["final"])
        grad_err, alike, step_err, worst = {}, [], {}, []
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
        res["cases"][name] = {
            "loss": [abs(r["loss"] - ref["loss"]) for r in rs],
            "grad_err": grad_err, "alike": alike, "step_err": step_err,
            "metrics": max(abs(a - b) / abs(b) for r in rs for x, y in
                           zip(r["metrics"], ref["metrics"]) for a, b in zip(x, y)),
            "router": sorted(k for k in grad_err if k.endswith("router"))}
    print(json.dumps(res, default=str))
"""


def _case(runs, name):
    return runs["cases"][name]


@pytest.mark.parametrize("name", list(CASES))
def test_tp_loss_and_gradient_blocks_match_jax(runs, name):
    r = _case(runs, name)
    assert max(r["loss"]) <= LOSS_TOL, r["loss"]
    bad = {k: v for k, v in r["grad_err"].items() if not v <= GRAD_TOL}
    assert not bad, bad
    assert len(r["grad_err"]) > 10


@pytest.mark.parametrize("name", list(CASES))
def test_replicated_leaves_gradients_are_alike_on_every_rank(runs, name):
    """The norms (and the leaves the guard leaves whole) have the same
    gradient, bit for bit, on every rank of the mesh."""
    r = _case(runs, name)
    assert r["alike"] and all(ok for _, ok in r["alike"]), [k for k, ok in r["alike"] if not ok]
    assert any(k.endswith("ln1") for k, _ in r["alike"])


@pytest.mark.parametrize("name", list(CASES))
def test_tp_train_steps_match_jax(runs, name):
    """Two steps of make_train_step on the mesh: each leaf of the rank's
    params and optimizer state (AdamW's moments, Adafactor's factored
    statistics, ZeRO-2's blocks) against its block of JAX's, within the
    module's tolerance (the ratio is distance over tolerance); the losses
    and grad norms of both steps."""
    r = _case(runs, name)
    bad = {k: v for k, v in r["step_err"].items() if not v <= 1.0}
    assert not bad, bad
    assert any(k.startswith("opt/") for k in r["step_err"])
    assert r["metrics"] <= METRIC_TOL, r["metrics"]


@pytest.mark.parametrize("name", ["phi3.5-moe-42b-a6.6b/1x2", "arctic-480b/1x2",
                                  "phi3.5-moe-42b-a6.6b/2x2"])
def test_router_gradient_matches_jax(runs, name):
    """Expert-TP: the combine's gradient of the gates is summed over the
    ranks and the aux loss's is not, so the router's gradient is JAX's (a
    blanket all-reduce would count the aux part n times)."""
    r = _case(runs, name)
    assert len(r["router"]) == 2   # one a layer
    for k in r["router"]:
        assert r["grad_err"][k] <= GRAD_TOL, (k, r["grad_err"][k])


@pytest.mark.parametrize("name", list(JAX_MESHES))
def test_jax_train_step_on_a_mesh_matches_its_single_device_step(runs, name):
    """Held as the port's steps are (the params' ratio is distance over
    the module's tolerance): the sharded step's sums round otherwise."""
    err = runs["jax_mesh"][name]
    assert isinstance(err, dict), err
    assert err["metrics"] <= METRIC_TOL and err["params"] <= 1.0, err


@pytest.mark.parametrize("smoke", ["smoke", "full"])
@pytest.mark.parametrize("arch", ZERO_SPEC_ARCHS)
def test_zero_blocks_in_local_coordinates_match_jax(runs, arch, smoke):
    """On a (2, 2) mesh each rank's ZeRO-2 block of every leaf is JAX's
    (`devices_indices_map` of the dry-run's grad shardings), and the port
    states it inside the rank's "model" block."""
    r = runs["zero_blocks"][f"{arch}/{smoke}"]
    assert r["bad"] == [], r["bad"]
    assert r["inside_model_blocks"] > 0


def test_trainer_on_a_tp_mesh_matches_one_process_and_checkpoints_its_blocks(runs):
    """The Trainer on a (1, 2) mesh (llama3-8b SMOKE, 3 steps, a checkpoint
    every 2 through the train state's shardings): each rank's final blocks
    against the one-process Trainer's, held as the steps above, and equal,
    bit for bit, to their blocks of the checkpoint the ranks wrote, restored
    whole in one process."""
    t = runs["trainer"]
    assert t["saved"] and all(ok for _, ok in t["saved"]), [k for k, ok in t["saved"] if not ok]
    bad = {k: v for k, v in t["steps"] if not v <= 1.0}
    assert not bad, bad


@pytest.mark.parametrize("n", [2, 4])
def test_collectives_backward(runs, n):
    """enter (f), all_reduce (g) and all_gather (its backward a
    reduce-scatter) carry the gradients Megatron's pair carries, and the
    vocab-parallel cross entropy and its gradient equal the whole
    vocabulary's on every rank."""
    for r in runs["units"][str(n)]:
        assert r["enter"] <= 1e-5 and r["reduce"] <= 1e-5 and r["gather"] <= 1e-5, r
        assert r["xent"] <= 1e-5 and r["xent_grad"] <= 1e-5, r


# ----------------------------------------------------------------- in process

@pytest.mark.parametrize("arch", ["xlstm-350m"])
def test_tp_training_refuses_the_other_families(arch, monkeypatch):
    """No family is refused TP training any more: the xLSTM's (ROADMAP item
    6c, held to JAX by tests/test_torch_tp_xlstm.py; the hybrid's and
    whisper's by tests/test_torch_tp_hybrid.py) builds on (1, 2) with the
    leaves it splits in its Split, and its train step is made, with AdamW
    and with Adafactor."""
    monkeypatch.setattr(torch.distributed, "get_rank", lambda group=None: 0)
    monkeypatch.setattr(torch.distributed, "get_world_size", lambda group=None: 2)
    mesh = Mesh((1, 2), ("data", "model"))
    model = build_model(get_config(arch, smoke=True), device="cpu", mesh=mesh)
    assert {p[-1] for p in model.split.dims} == {"tok", "w_up", "w_q", "w_k", "w_v",
                                                 "w_down", "w_gates", "w_ff1"}
    for opt in ("adamw", "adafactor"):
        assert make_train_step(model, make_optimizer(opt), lambda s: 1e-3,
                               mesh=mesh) is not None


@pytest.mark.parametrize("arch", ["arctic-480b", "internvl2-76b", "qwen1.5-32b"])
def test_tp_training_of_fsdp_archs_on_a_data_axis(arch, monkeypatch):
    """The FSDP archs (at their published configs; SMOKE turns FSDP off)
    build on (2, 2), each rank holding the reference's blocks: every
    projection and the embeddings cut over "data" too, gathered before use,
    the arch's training step made with its own optimizer (arctic-480b's
    Adafactor on those leaves too). On (1, n) they build, with a loss."""
    from repro_torch.launch.dryrun import fake_mesh
    from repro_torch.sharding.rules import model_shardings
    from repro_torch.tree import leaves
    cfg = get_config(arch)
    assert cfg.fsdp
    whole = build_model(cfg, device="meta").init_params(torch.Generator())
    with fake_mesh(Mesh((2, 2), ("data", "model"))) as m:
        model = build_model(cfg, device="meta", mesh=m)
        mine = model.init_params(torch.Generator())
        sh = model_shardings(whole, cfg, m, single_pod_rules())
        assert [tuple(t.shape) for t in leaves(mine)] == \
            [tuple(t[b].shape) for t, b in zip(leaves(whole), sh.index(whole, 0))]
        assert ("layers", "attn", "wq") in model.dp.gathers and ("embed", "tok") in model.dp.gathers
        opt = make_optimizer(cfg.optimizer)
        assert make_train_step(model, opt, lambda s: 1e-3) is not None
    monkeypatch.setattr(torch.distributed, "get_rank", lambda group=None: 0)
    monkeypatch.setattr(torch.distributed, "get_world_size", lambda group=None: 2)
    model = build_model(cfg, device="meta", mesh=Mesh((1, 2), ("data", "model")))
    assert model.tp is not None and model.split.dims


def test_zero1_of_adafactor_holds_the_rank_s_blocks():
    """ZeRO-1 of arctic SMOKE's Adafactor state on a (2, 1) mesh (its
    experts cut over "data" too): rank 0's statistics are its blocks of the
    whole leaf's under the train state's shardings (whole layers of a
    stacked leaf, empty for the other rank's layers; a block of a stack of
    norms), and the ZeRO-2 step builds."""
    from repro_torch.launch.dryrun import fake_group
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.sharding.rules import state_shardings
    from repro_torch.tree import flatten
    cfg = get_config("arctic-480b", smoke=True)
    whole = build_model(cfg, device="meta").init_params(torch.Generator())
    opt = make_optimizer("adafactor")
    with fake_group(2):
        mesh = make_mesh((2, 1), ("data", "model"), device="cpu")
        model = build_model(cfg, device="meta", mesh=mesh)
        g_sh = shardings_for(whole, cfg, mesh, single_pod_rules(), zero1=True)
        state = train_state(model.init_params(torch.Generator()), opt, g_sh, model.split)
        sh = state_shardings(train_state(whole, opt), cfg, mesh, single_pod_rules(), g_sh)
        kinds = set()
        for (path, leaf), b in zip(flatten(state), sh.index(state, 0)):
            want = (0,) if b is None else tuple(s.stop - s.start for s in b)
            assert tuple(leaf.shape) == want, (path, tuple(leaf.shape), want)
            if path[:2] == ("opt", "s"):
                kinds.add("empty" if b is None else "whole" if want == sh.full_shape(path)
                          else "cut")
        assert kinds == {"empty", "whole", "cut"}, kinds
        assert make_train_step(model, opt, lambda s: 1e-3, grad_shardings=g_sh) is not None

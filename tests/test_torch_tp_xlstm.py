"""Tensor parallelism of the xLSTM over the "model" axis, serving and
training (models/tensor_parallel.py's xLSTM plan and `all_gather(...,
partial=False)`; the TP paths of models/xlstm.py; registry's sharded
xLSTM; bridge.shard_params, shard_cache and shard_train_state over its
nested mLSTM lists; the Trainer's checkpoints of its TP train state)
against the JAX package, on the CPU.

One subprocess runs JAX with four host devices
(`--xla_force_host_platform_device_count=4`, Auto axes) and, in a thread
beside JAX's own runs, the port's ranks: gloo processes on the CPU started
by `repro_torch.distributed.spawn`, one spawn per world size (2 and 4)
serving every case; the rank bodies are in tests/_torch_tp_xlstm_ranks.py
(and `train_rank` of tests/_torch_tp_ranks.py). Every input comes from
numpy with a seed; both sides run fp32, from the same JAX-initialised params
or train state handed over by the bridge.

The model: xlstm SMOKE (d_model 64, 2 heads, d_in 128, 4 layers: 2
super-blocks of an mLSTM and an sLSTM block, GeGLU width 85). On (1, 2)
its heads split, one a rank: w_up's product is gathered ([xi | z]: rank 0
holds xi, rank 1 z), the rank's w_q/w_k/w_v and w_gates columns are its
head's, and the GeGLU's w_ff1 product ([a | b]) is gathered, w_ff2's 85
rows whole. On (1, 4) its 2 heads do not divide the axis: the guard's
column case, q/k/v's and the gate product's columns gathered, every rank
running both heads and multiplying its 32 channels of the mLSTM's output by
its rows of w_down; w_ff1's 170 columns are whole.

Serving, on (1, 2), (1, 4) and (2, 2) (each data rank its rows of the
batch): the prefill logits (4 x 12 tokens) and 4 decode steps' logits
against JAX's single-device `prefill`/`decode_step` on the bridged params,
atol = rtol = 1e-5 (float rounding, sums in another order across the
ranks); the ranks' logits identical; each rank's states after the prefill
(empty, as the reference's) and after the steps against its part of JAX's
(`bridge.shard_cache`: its rows, and its heads of every state, m_C too,
which the reference's cache specs leave whole) within 1e-5 relative L2 a
leaf: m_C's entries are sums of gated k v products that cancel, so an entry
near 0 carries the rounding of its terms, not of itself (the single-process
port sits 6.5e-6 past an elementwise atol = rtol = 1e-5 bound on this
batch's m_C, at such an entry); JAX's own run under a (1, n) mesh with Auto axes and `axis_rules` against
its single-device run on (1, 4).

Training, on (1, 2), (1, 4) and on (2, 2) with ZeRO-2, with AdamW and with
Adafactor (4 x 16 tokens, 2 microbatches, a constant 1e-2), held as
tests/test_torch_tp_hybrid.py holds the hybrid: the loss at the step-0
params within 1e-5; each gradient block within 1e-4 relative L2 of its
block of `jax.grad` of the single-device loss; every leaf no rank splits
bit-identical on every rank; after 2 steps every block of the params and
the optimizer state within a hundredth of what the steps moved it (or 1e-5
x sqrt(size)) of the single-process port's 2 steps from the same state,
and of JAX's; the steps' losses and grad norms within 1e-5 (step 1) and
1e-4 (step 2) relative. The bound is raised to NOISE_FACTOR times a
leaf's rounding floor where that floor exceeds it, as chip_smoke.py gates
its ranks: the floor is the distance between two single-process runs whose
sums differ in order only, the port's and JAX's. That raises it for the
sLSTM's b_gates under Adafactor alone (the single processes 1.12 bounds
apart on this batch): the first update of a vector leaf that starts at 0
is about lr x sign(g) entry by entry, and the sequential sLSTM's gradient
differs from JAX's by ~1e-5 relative, which moves entries of g near 0
(tests/test_torch_family_train.py's docstring).

The Trainer on (1, 2): from JAX's step-0 train state (bridged and saved
whole at step 0, which each rank restores its blocks of), 3 steps of
TokenPipeline batches (warmup_cosine(1e-2, 1, 3): the first step's LR is
0) with a checkpoint every 2, straight and crashed at step 2 and
restarted: the two end bit for bit alike, and the straight run's last
checkpoint, read whole in one process, is held to JAX's 3 single-device
steps on the same batches and schedule as the steps above.

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
from repro_torch.models import build_model, xlstm
from repro_torch.models.tensor_parallel import TensorParallel
from repro_torch.sharding.axes import single_pod_rules
from repro_torch.sharding.rules import model_shardings
from repro_torch.tree import flatten

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT = 300
SERVE = {"1x2": (1, 2), "1x4": (1, 4), "2x2": (2, 2)}
# name -> (optimizer, mesh shape, ZeRO-2)
TRAIN = {f"{opt}/{name}": (opt, shape, zero) for opt in ("adamw", "adafactor")
         for name, shape, zero in (("1x2", (1, 2), False), ("1x4", (1, 4), False),
                                   ("2x2-zero2", (2, 2), True))}
TRAINER_SHAPE = (1, 2)
JAX_MESH = ["1x4"]
SPEC_MESHES = {"1x2": (1, 2), "1x4": (1, 4), "2x2": (2, 2)}
TOL, LOSS_TOL, GRAD_TOL, STEP_REL, STEP_ABS = 1e-5, 1e-5, 1e-4, 1e-2, 1e-5
METRIC_TOL = (1e-5, 1e-4)   # the steps' loss and grad norm: step 1, step 2
NOISE_FACTOR = 2.0          # times a leaf's rounding floor, where it exceeds the bound


def step_bounds(r):
    """Each leaf's bound on the steps, in units of the hundredth of the
    update: 1, or NOISE_FACTOR times its rounding floor (the single-process
    port's distance to JAX's steps) where that is larger."""
    return {k: max(1.0, NOISE_FACTOR * v) for k, v in r["single_jax"].items()}


def smoke():
    return get_config("xlstm-350m", smoke=True).replace(param_dtype="float32")


SCRIPT = """
    import json
    import os
    import tempfile
    import threading
    import numpy as np
    import jax, jax.numpy as jnp
    import torch
    from repro.configs import get_config as jget
    from repro.models import build_model as jbuild
    from repro.optim.optimizers import make_optimizer as jopt, warmup_cosine as jcosine
    from repro.sharding import axes as JA, rules as JR
    from repro.train import steps as JS
    from repro_torch import bridge
    from repro_torch import distributed as D
    from repro_torch.checkpoint.checkpointer import Checkpointer
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, TokenPipeline
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models import build_model
    from repro_torch.optim.optimizers import make_optimizer
    from repro_torch.sharding.axes import single_pod_rules
    from repro_torch.train.steps import make_train_step
    from repro_torch.sharding import rules as R
    from repro_torch.tree import flatten
    import test_torch_tp_xlstm as T
    import _torch_tp_xlstm_ranks as XR

    B, T_, S, STEPS = 4, 12, 16, 4                  # serving
    TB, TT, LR, TSTEPS, MICRO = 4, 16, 1e-2, 2, 2   # training
    rng = np.random.default_rng(5)
    jcfg = jget("xlstm-350m", smoke=True).replace(param_dtype="float32")
    cfg = T.smoke()
    jm = jbuild(jcfg)

    def np_tree(t):
        return jax.tree.map(np.asarray, t)

    def run_serve(jp, batch, steps):
        jl, jpc = jax.jit(jm.prefill)(jp, batch)
        jc, dec, step = jpc, [], jax.jit(jm.decode_step)
        for i, t in enumerate(steps):
            lg, jc = step(jp, jc, {"tokens": jnp.asarray(t),
                                   "positions": jnp.full((B,), T_ + i, jnp.int32)})
            dec.append(np.asarray(lg))
        return np.asarray(jl), np_tree(jpc), dec, np_tree(jc)

    # ---- serving: one draw, one single-device run
    jp = jm.init_params(jax.random.PRNGKey(0))
    batch = {"tokens": rng.integers(0, jcfg.vocab_size, (B, T_)).astype(np.int32)}
    steps = [rng.integers(0, jcfg.vocab_size, (B, 1)).astype(np.int32) for _ in range(STEPS)]
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    serve_cases = {2: {}, 4: {}}
    for name, shape in T.SERVE.items():
        serve_cases[shape[0] * shape[1]][name] = {"shape": shape, "params": np_tree(jp),
                                                  "batch": batch, "S": S, "steps": steps}

    # ---- training: JAX's state 0 an optimizer and a batch, from their own generator
    rng = np.random.default_rng(11)
    tb = {"tokens": rng.integers(0, jcfg.vocab_size, (TB, TT)).astype(np.int32),
          "targets": rng.integers(0, jcfg.vocab_size, (TB, TT)).astype(np.int32)}
    jtb = {k: jnp.asarray(v) for k, v in tb.items()}
    trefs, train_cases = {}, {2: {}, 4: {}}
    for opt_name in ("adamw", "adafactor"):
        opt = jopt(opt_name)
        state0 = JS.make_init_state(jbuild(jcfg.replace(optimizer=opt_name)), opt)(
            jax.random.PRNGKey(1))
        trefs[opt_name] = dict(opt=opt, state0_j=state0, state0=np_tree(state0))
    singles = {}   # the single-process port's steps from the same state
    for opt_name, ref in trefs.items():
        tm = build_model(cfg.replace(optimizer=opt_name), device="cpu")
        st = bridge.train_state_from_jax(ref["state0"])
        step = make_train_step(tm, make_optimizer(opt_name), lambda s: torch.tensor(LR),
                               n_microbatches=MICRO)
        for _ in range(TSTEPS):
            st, _ = step(st, {k: torch.from_numpy(v) for k, v in tb.items()})
        singles[opt_name] = st
    for name, (opt_name, shape, zero) in T.TRAIN.items():
        train_cases[shape[0] * shape[1]][name] = {
            "arch": "xlstm-350m", "config": {"optimizer": opt_name}, "shape": shape,
            "zero": zero, "state": trefs[opt_name]["state0"], "batch": tb, "lr": LR,
            "steps": TSTEPS, "micro": MICRO}

    # ---- the Trainer: JAX's AdamW state 0 saved whole at step 0, twice
    root = tempfile.mkdtemp()
    whole0 = bridge.train_state_from_jax(trefs["adamw"]["state0"])
    for d in ("straight", "crashed"):
        Checkpointer(os.path.join(root, d)).save(0, whole0, blocking=True)
    n_tr = T.TRAINER_SHAPE[0] * T.TRAINER_SHAPE[1]

    ranks = {}

    def run_ranks():   # the ranks run beside JAX's own runs below
        for n in (2, 4):
            jobs = {"serve": ("serve_rank", (serve_cases[n],)),
                    "train": ("train_rank", (train_cases[n],))}
            if n == n_tr:
                jobs["trainer"] = ("trainer_rank", (T.TRAINER_SHAPE, root))
            ranks[n] = D.spawn(XR.world_rank, n, jobs, device="cpu", timeout=240)

    thread = threading.Thread(target=run_ranks)
    thread.start()

    want = run_serve(jp, jbatch, steps)
    jax_mesh = {}
    for name in T.JAX_MESH:
        shape = T.SERVE[name]
        mesh = jax.make_mesh(shape, ("data", "model"),
                             axis_types=(jax.sharding.AxisType.Auto,) * 2)
        rules = JA.single_pod_rules()
        try:
            jps = jax.device_put(jp, JR.named_shardings(jp, jcfg, mesh, rules))
            with mesh, JA.axis_rules(mesh, rules):
                got = run_serve(jps, jbatch, steps)
            jax_mesh[name] = max([float(np.abs(got[0] - want[0]).max())]
                                 + [float(np.abs(a - b).max()) for a, b in zip(got[2], want[2])])
        except Exception as e:
            jax_mesh[name] = f"{type(e).__name__}: {e}"[:300]
    loss, grads = jax.jit(jax.value_and_grad(lambda p: jm.loss(p, jtb)[0]))(
        trefs["adamw"]["state0_j"]["params"])
    for opt_name, ref in trefs.items():
        step = jax.jit(JS.make_train_step(jm, ref["opt"], lambda s: jnp.float32(LR),
                                          n_microbatches=MICRO))
        st, metrics = ref["state0_j"], []
        for _ in range(TSTEPS):
            st, m = step(st, jtb)
            metrics.append((float(m["loss"]), float(m["grad_norm"])))
        ref.update(metrics=metrics, final=np_tree(st))
    # the Trainer's 3 steps, single device, on its batches and schedule
    pipe = TokenPipeline(DataConfig(vocab_size=jcfg.vocab_size, **XR.DATA))
    tr = XR.TRAINER
    step = jax.jit(JS.make_train_step(jm, trefs["adamw"]["opt"],
                                      jcosine(tr["base_lr"], tr["warmup"], tr["num_steps"]),
                                      n_microbatches=tr["n_microbatches"]))
    st = trefs["adamw"]["state0_j"]
    for i in range(tr["num_steps"]):
        st, _ = step(st, {k: jnp.asarray(v) for k, v in pipe.batch_at(i).items()})
    trainer_final = np_tree(st)

    # ---- specs: the port's blocks against JAX's named_shardings
    def names(path):
        return tuple(getattr(k, "key", getattr(k, "name", None)) for k in path)

    def norm(spec):
        return [e[0] if isinstance(e, tuple) and len(e) == 1 else
                (list(e) if isinstance(e, tuple) else e) for e in spec]

    specs = {}
    for sm in (True, False):
        jc_, c_ = jget("xlstm-350m", smoke=sm), get_config("xlstm-350m", smoke=sm)
        jparams = jax.eval_shape(jbuild(jc_).init_params, jax.random.PRNGKey(0))
        params = build_model(c_, device="meta").init_params(torch.Generator())
        for mname, shape in T.SPEC_MESHES.items():
            jmesh = jax.make_mesh(shape, ("data", "model"),
                                  axis_types=(jax.sharding.AxisType.Auto,) * 2)
            mesh = Mesh(shape, ("data", "model"))
            sh = R.shardings_for(params, c_, mesh, single_pod_rules())
            jsh = JR.named_shardings(jparams, jc_, jmesh, JA.single_pod_rules())
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
            specs[f"{'smoke' if sm else 'full'}/{mname}"] = {"bad": bad[:5], "split": split}
    thread.join()

    def excess(got, w):
        return float(np.max(np.abs(got - w) - (T.TOL + T.TOL * np.abs(w))))

    res = {"serve": {}, "train": {}, "jax_mesh": jax_mesh, "specs": specs}
    wl, wpc, wdec, wc = want
    for name, shape in T.SERVE.items():
        n = shape[0] * shape[1]
        pmesh = Mesh(shape, ("data", "model"))
        rs = [r["serve"][name] for r in ranks[n]]
        caches = []
        for rank, r in enumerate(rs):
            errs = {}
            for kind, got_c, w_c in (("prefill", r["prefill_cache"], wpc), ("final", r["cache"], wc)):
                mine = bridge.shard_cache(w_c, cfg, pmesh, rank, B)
                for k, w in mine.items():
                    errs[f"{kind}/{k}"] = (
                        float(np.linalg.norm(got_c[k] - w) / max(np.linalg.norm(w), 1e-30))
                        if got_c[k].shape == w.shape else f"shape {got_c[k].shape} != {w.shape}")
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

    def step_errs(got_state, w0, w2):
        errs = {}
        for k, got in got_state.items():
            want2, start = w2[k].astype(np.float32), w0[k].astype(np.float32)
            tol = max(T.STEP_ABS * np.sqrt(max(got.size, 1)),
                      T.STEP_REL * float(np.linalg.norm(want2 - start)))
            d = float(np.linalg.norm(got - want2))
            errs[k] = d / tol if tol else d
        return errs

    def by_path(tree):
        return {"/".join(map(str, p)): t.numpy() for p, t in flatten(tree)}

    jgrads = bridge.params_from_jax(np_tree(grads))
    for name, (opt_name, shape, zero) in T.TRAIN.items():
        ref, n = trefs[opt_name], shape[0] * shape[1]
        tcfg = cfg.replace(optimizer=opt_name)
        pmesh = Mesh(shape, ("data", "model"))
        rs = [r["train"][name] for r in ranks[n]]
        msh = R.model_shardings(jgrads, tcfg, pmesh, single_pod_rules())
        gsh = (R.shardings_for(jgrads, tcfg, pmesh, single_pod_rules(), zero1=True)
               if zero else None)
        s0 = bridge.train_state_from_jax(ref["state0"])
        s2 = bridge.train_state_from_jax(ref["final"])
        grad_err, alike, step_err, single_err, single_jax = {}, [], {}, {}, {}
        for rank, r in enumerate(rs):
            wg = by_path(msh.take(jgrads, rank))
            for k, g in r["grads"].items():
                grad_err[k] = max(grad_err.get(k, 0.0), rel(g, wg[k]))
            w0, w2, ws = (by_path({"params": w["params"], "opt": w["opt"]}) for w in (
                bridge.shard_train_state(s, tcfg, pmesh, rank, gsh)
                for s in (s0, s2, singles[opt_name])))
            assert set(w2) == set(r["state"]), sorted(set(w2) ^ set(r["state"]))[:5]
            for errs, got, w in ((step_err, r["state"], w2), (single_err, r["state"], ws),
                                 (single_jax, ws, w2)):
                for k, v in step_errs(got, w0, w).items():
                    errs[k] = max(errs.get(k, 0.0), v)
        sizes = {k: v.size for k, v in by_path(jgrads).items()}
        for k in rs[0]["grads"]:
            if rs[0]["grads"][k].size == sizes[k]:   # a leaf no rank splits
                alike.append([k, all(np.array_equal(r["grads"][k], rs[0]["grads"][k])
                                     for r in rs)])
        res["train"][name] = {
            "loss": [abs(r["loss"] - float(loss)) for r in rs],
            "grad_err": grad_err, "alike": alike, "step_err": step_err,
            "single_err": single_err, "single_jax": single_jax,
            "metrics": [max(abs(a - b) / abs(b) for r in rs for a, b in
                            zip(r["metrics"][i], ref["metrics"][i])) for i in range(TSTEPS)]}

    # the Trainer: its last checkpoint read whole against JAX's 3 steps
    tr_ranks = [r["trainer"] for r in ranks[n_tr]]
    read = Checkpointer(os.path.join(root, "straight")).restore(
        bridge.train_state_from_jax(trefs["adamw"]["state0"]), step=XR.TRAINER["num_steps"])
    w3 = bridge.train_state_from_jax(trainer_final)
    pick = lambda s: by_path({"params": s["params"], "opt": s["opt"]})
    res["trainer"] = {"ranks": tr_ranks, "step": int(read["step"]),
                      "step_err": step_errs(pick(read), pick(whole0), pick(w3))}
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
def test_tp_states_are_the_ranks_parts_of_jax_s(runs, name):
    """Every state after the prefill (empty) and after 4 decode steps: the
    rank's rows and heads of JAX's whole state (`bridge.shard_cache`),
    within TOL relative L2 a leaf (see the module's docstring)."""
    caches = runs["serve"][name]["caches"]
    assert len(caches) == SERVE[name][0] * SERVE[name][1]
    for c in caches:
        assert len(c) == 14 and all(isinstance(v, float) and v <= TOL for v in c.values()), c


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
    assert len(r["grad_err"]) == 34


@pytest.mark.parametrize("name", list(TRAIN))
def test_replicated_leaves_gradients_are_alike_on_every_rank(runs, name):
    """The leaves no rank splits, among them those a rank reads only its
    heads' part of where the heads split (w_if, b_if, norm_w, b_gates,
    r_gates), have the same gradient, bit for bit, on every rank."""
    alike = dict(runs["train"][name]["alike"])
    assert alike and all(alike.values()), [k for k, ok in alike.items() if not ok]
    for leaf in ("w_if", "b_if", "norm_w", "b_gates", "r_gates", "ln", "final_norm"):
        assert any(k.endswith(leaf) for k in alike), leaf


@pytest.mark.parametrize("name", list(TRAIN))
def test_tp_train_steps_match_jax(runs, name):
    """Every block within a hundredth of JAX's update, or NOISE_FACTOR times
    its rounding floor where that is larger (`step_bounds`): only the
    sLSTM's b_gates under Adafactor."""
    r = runs["train"][name]
    bound = step_bounds(r)
    bad = {k: v for k, v in r["step_err"].items() if not v <= bound[k]}
    assert not bad, bad
    raised = {k for k, b in bound.items() if b > 1.0}
    assert raised <= ({"params/slstm/0/b_gates", "params/slstm/1/b_gates"}
                      if name.startswith("adafactor") else set()), raised
    assert any(k.startswith("opt/") for k in r["step_err"])
    assert all(m <= tol for m, tol in zip(r["metrics"], METRIC_TOL)), r["metrics"]


@pytest.mark.parametrize("name", list(TRAIN))
def test_tp_train_steps_match_the_single_process(runs, name):
    """Every block of the params and the optimizer state within a hundredth
    of the update of the single-process port's 2 steps from the same state
    (`step_bounds`)."""
    r = runs["train"][name]
    bound = step_bounds(r)
    bad = {k: v for k, v in r["single_err"].items() if not v <= bound[k]}
    assert not bad, bad
    assert set(r["single_err"]) == set(r["step_err"])


def test_trainer_checkpoints_of_a_tp_state(runs):
    """The Trainer on (1, 2), crashed at step 2 and restarted, ends bit for
    bit where the straight run ends; each rank restored its blocks of a
    whole step-0 checkpoint and holds a block of the split leaves; the last
    checkpoint, read whole, is within a hundredth of JAX's update."""
    r = runs["trainer"]
    assert all(x["equal"] and x["start"] == 2 and x["split"] > 10 for x in r["ranks"]), r["ranks"]
    assert r["step"] == 3
    bad = {k: v for k, v in r["step_err"].items() if not v <= 1.0}
    assert not bad, bad
    assert any(k.startswith("opt/m/") for k in r["step_err"])


@pytest.mark.parametrize("mesh", list(SPEC_MESHES))
@pytest.mark.parametrize("smoke_", ["smoke", "full"])
def test_param_specs_and_blocks_match_jax(runs, smoke_, mesh):
    r = runs["specs"][f"{smoke_}/{mesh}"]
    assert r["bad"] == [], r["bad"]
    assert r["split"] > 0


def test_plans_of_the_heads_and_the_guard_cases(runs):
    """SMOKE's 2 heads split 1 a rank at n = 2 (w_ff1's 170 columns
    gathered); at n = 4 they do not: q/k/v's and the gates' columns are
    gathered, each rank holds 32 channels of d_in, and w_ff1 is whole."""
    two = runs["serve"]["1x2"]["plans"]
    assert [p["xl_heads"] for p in two] == [[0, 1], [1, 2]]
    assert two[1]["xl_channels"] == [64, 128] and two[0]["gather_ff"]
    four = runs["serve"]["1x4"]["plans"]
    assert all(p["xl_heads"] is None and not p["gather_ff"] for p in four)
    assert [p["xl_channels"] for p in four] == [[0, 32], [32, 64], [64, 96], [96, 128]]
    assert [p["xl_heads"] for p in runs["serve"]["2x2"]["plans"]] == [[0, 1], [1, 2]] * 2


# ----------------------------------------------------------------- in process

def _plan(cfg, n, r, monkeypatch):
    monkeypatch.setattr(torch.distributed, "get_rank", lambda group=None: r)
    monkeypatch.setattr(torch.distributed, "get_world_size", lambda group=None: n)
    return TensorParallel.plan(cfg, None)


@pytest.mark.parametrize("n", [2, 4])
def test_full_width_plans(monkeypatch, n):
    """xlstm-350m (d 1024, 4 heads, d_in 2048, GeGLU width 1365): its heads
    split at n = 2 and 4, each rank's w_gates block of 4096 / n columns its
    heads' z, i, f and o, its w_q block its heads' 2048 / n columns; w_up's
    product is gathered (at n = 4 ranks 0-1 hold xi's columns, 2-3 z's);
    w_ff1 (2730 columns) is split into [a | b] and gathered at n = 2 and
    whole at n = 4; w_ff2's 1365 rows are whole at both."""
    cfg = get_config("xlstm-350m")
    whole = xlstm.init_params(torch.Generator(), cfg, device="meta")
    mesh = Mesh((1, n), ("data", "model"))
    sh = model_shardings(whole, cfg, mesh, single_pod_rules())
    for r in range(n):
        p = _plan(cfg, n, r, monkeypatch)
        assert p.xl_heads == slice(r * 4 // n, (r + 1) * 4 // n)
        assert p.xl_channels == slice(r * 2048 // n, (r + 1) * 2048 // n)
        assert p.gather_ff == (n == 2)
        assert p.vocab_rows == slice(r * 50432 // n, (r + 1) * 50432 // n)
        blk = sh.block_of(("slstm", 0, "w_gates"), r)[1]
        assert blk == slice(p.xl_heads.start * 1024, p.xl_heads.stop * 1024)
        assert sh.block_of(("mlstm", 0, 0, "w_q"), r)[1] == p.xl_channels
        assert sh.block_of(("mlstm", 0, 0, "w_down"), r)[0] == p.xl_channels
        up = sh.block_of(("mlstm", 0, 0, "w_up"), r)[1]
        assert (up.stop <= 2048) == (r < n // 2)     # xi's columns, else z's
        ff1 = sh.block_of(("slstm", 0, "w_ff1"), r)[1]
        assert (ff1.stop - ff1.start) == (1365 if n == 2 else 2730)
        assert sh.block_of(("slstm", 0, "w_ff2"), r) == (slice(0, 1365), slice(0, 1024))


@pytest.mark.parametrize("n,over", [(3, {}), (4, {"d_model": 96})])
def test_plan_refuses_splits_the_port_does_not_run(monkeypatch, n, over):
    """n not dividing d_in (SMOKE's 128 at n = 3) would leave the mLSTM's
    output whole on every rank while its input is split; n dividing the
    GeGLU's width (128 of a SMOKE variant of d_model 96, at n = 4) would
    split w_ff2's rows, which no config does: both refused."""
    with pytest.raises(NotImplementedError, match=f"splits the xLSTM {n} ways"):
        _plan(get_config("xlstm-350m", smoke=True).replace(**over), n, 0, monkeypatch)


@pytest.mark.parametrize("shape", [(1, 2), (1, 4), (2, 2)])
def test_per_rank_init_blocks_are_the_whole_init_s(shape):
    """init_params(mesh=, rank=) draws every leaf whole from the same stream
    and keeps the rank's block: bit for bit the block of the whole draw
    under `model_shardings` (SMOKE, on the CPU); at full width on the meta
    device the blocks' shapes."""
    mesh = Mesh(shape, ("data", "model"))
    for smoke_ in (True, False):
        cfg = get_config("xlstm-350m", smoke=smoke_)
        dev = "cpu" if smoke_ else "meta"
        gen = (lambda: torch.Generator().manual_seed(3)) if smoke_ else torch.Generator
        whole = xlstm.init_params(gen(), cfg, device=dev)
        sh = model_shardings(whole, cfg, mesh, single_pod_rules())
        for rank in range(shape[0] * shape[1]):
            mine = xlstm.init_params(gen(), cfg, device=dev, mesh=mesh, rank=rank)
            for (path, got), (_, w), b in zip(flatten(mine), flatten(whole),
                                              sh.index(whole, rank)):
                assert got.shape == w[b].shape, path
                if smoke_:
                    assert torch.equal(got, w[b]) and got.is_contiguous(), path
            n_mine = sum(t.numel() for _, t in flatten(mine))
            assert n_mine < sum(t.numel() for _, t in flatten(whole))


@pytest.mark.parametrize("shape", [(1, 2), (1, 4), (2, 2), (2, 4)])
def test_build_model_on_tp_meshes_at_full_width(shape):
    """xlstm-350m builds on (1, 2), (1, 4), (2, 2) and the dry-run's (2, 4)
    (fake process groups, the meta device): rank 0's params are its blocks,
    its cache holds its heads of every state (m_C too), and its Split names
    every leaf cut over "model"."""
    from repro_torch.launch.dryrun import fake_mesh
    cfg = get_config("xlstm-350m")
    whole = build_model(cfg, device="meta").init_params(torch.Generator())
    with fake_mesh(Mesh(shape, ("data", "model"))) as m:
        model = build_model(cfg, device="meta", mesh=m)
        mine = model.init_params(torch.Generator())
        sh = model_shardings(whole, cfg, m, single_pod_rules())
        assert [tuple(t.shape) for _, t in flatten(mine)] == \
            [tuple(w[b].shape) for (_, w), b in zip(flatten(whole), sh.index(whole, 0))]
        assert model.dp is None
        assert {p[-1] for p in model.split.dims} == {"tok", "w_up", "w_q", "w_k", "w_v",
                                                     "w_down", "w_gates", "w_ff1"} - \
            ({"w_ff1"} if shape[1] == 4 else set())
        cache = model.init_cache(2)
        h = 4 // shape[1]
        assert cache["m_C"].shape == (3, 7, 2, h, 512, 512)
        assert cache["s_c"].shape == (3, 2, h, 256) and cache["m_m"].shape == (3, 7, 2, h)

"""The port's multi-rank paths against the JAX package, on the CPU: the int8
ring all-reduce (optim/compression.py), the data-parallel and ZeRO-2 train
step (train/steps.py under a mesh) and the MoE dispatch groups with the
global aux loss (models/moe.py under a data-parallel group).

Every multi-rank case runs in a subprocess, as
tests/test_infra_multi_device.py runs the JAX package's: JAX with
`--xla_force_host_platform_device_count`, and the port's ranks as gloo
processes on the CPU started by `repro_torch.distributed.spawn` (a
`file://` rendezvous in a temporary directory, a timeout on every
collective). The pytest process never initialises a process group. Each
subprocess runs once per module (a fixture) and prints its measurements as
JSON; the tests hold them to their tolerances:
  * compression, W=8 against JAX's 8-device shard_map on the same (8, 128)
    input: the mean and the residual within 1e-6 (a code that rounds the
    other way moves a dequantised value by one scale step, which shows in
    these values); and the reference test's own properties (relative error
    < 0.05, the 20-step error-feedback drift bound);
  * the train step, llama3-8b SMOKE in fp32, W=2, 2 microbatches, 3 AdamW
    steps at a constant learning rate: plain data parallelism and ZeRO-2
    each within 1e-6 (relative L2 over every param) of the port's
    single-process step on the global batch, losses and grad norms within
    1e-5 relative; ZeRO-2 within 1e-4 (relative L2, each leaf) of JAX's step
    under a (2, 1) mesh with the same ZeRO-2 grad shardings; each rank's
    ZeRO state holds 1/W of the entries;
  * MoE groups, phi3.5-moe SMOKE in fp32: W=2 ranks with n_groups=1, each on
    its contiguous half of the batch, against JAX's single-device lm_loss
    with n_groups=2 on the whole batch: the mean of the ranks' losses and
    their aux loss within 1e-5 relative, the mean of their gradients within
    1e-4 relative L2 each leaf; with the aux loss's means taken per rank the
    aux loss misses JAX's by far more than that tolerance;
  * a masked loss (llama3-8b and zamba2-2.7b SMOKE) on W=2 ranks whose
    halves weigh differently: the mean of the ranks' losses is the whole
    batch's, to 1e-6 relative;
  * phi3.5-moe SMOKE's ZeRO-2 step on a (2, 2, 1) ("pod", "data", "model")
    mesh with the multi-pod rules (experts split over data, EP, and d_model
    over pod, gathered before use): the ranks' blocks put together within
    1e-6 of one process with 4 dispatch groups.
"""
import pytest

import _torch_subproc as subproc


def _run(script: str, devices: int) -> dict:
    return subproc.run(script, devices=devices)


@pytest.fixture(scope="module")
def compression():
    return _run("""
        import json
        from functools import partial
        import numpy as np
        import jax, jax.numpy as jnp
        from jax.experimental.shard_map import shard_map
        from jax.sharding import PartitionSpec as P
        from repro.optim.compression import compressed_psum_mean
        from repro_torch import distributed as D
        import _torch_dist_ranks as R

        g = np.random.default_rng(0).standard_normal((8, 128)).astype(np.float32)
        mesh = jax.make_mesh((8,), ("data",), axis_types=(jax.sharding.AxisType.Auto,))
        fn = jax.jit(shard_map(partial(compressed_psum_mean, axis_name="data"), mesh=mesh,
                               in_specs=(P("data"), P("data")),
                               out_specs=(P("data"), P("data"))))
        jmean, jerr = (np.asarray(a) for a in fn(g, np.zeros_like(g)))
        out = D.spawn(R.compression_rank, 8, g, 20, device="cpu", timeout=120)
        mean, err, avg = (np.concatenate([o[i] for o in out]) for i in range(3))
        exact = np.broadcast_to(g.mean(0, keepdims=True), g.shape)
        print(json.dumps({
            "mean_vs_jax": float(np.abs(mean - jmean).max()),
            "err_vs_jax": float(np.abs(err - jerr).max()),
            "rows_alike": bool((mean == mean[:1]).all()),
            "rel": float(np.abs(mean - exact).max() / np.abs(exact).max()),
            "drift": float(np.abs(avg - exact).max()),
            "drift_bound": float(0.02 * np.abs(exact).max() + 0.02)}))
    """, devices=8)


@pytest.fixture(scope="module")
def parity():
    return _run("""
        import json
        import numpy as np
        import jax, jax.numpy as jnp
        import torch
        from jax.sharding import NamedSharding, PartitionSpec as P
        from repro.configs import get_config as jget
        from repro.models import build_model as jbuild
        from repro.optim import optimizers as JO
        from repro.sharding import rules as JR
        from repro.sharding.axes import _guard_divisibility, single_pod_rules
        from repro.train import steps as JS
        from repro_torch import bridge, distributed as D
        from repro_torch.models import build_model
        from repro_torch.optim.optimizers import make_optimizer
        from repro_torch.train import steps as S
        from repro_torch.tree import flatten
        import _torch_dist_ranks as R

        def jax_setup(arch, **kw):
            jcfg = jget(arch, smoke=True).replace(param_dtype="float32")
            jm = jbuild(jcfg, **kw)
            return jcfg, jm, jm.init_params(jax.random.PRNGKey(0))

        def batch(rng, vocab, B, T):
            t = rng.integers(0, vocab, (B, T + 1)).astype(np.int32)
            return {"tokens": t[:, :-1].copy(), "targets": t[:, 1:].copy()}

        def rel(a, b):
            return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))

        def cat(tree):
            return np.concatenate([np.ravel(a) for _, a in flatten(tree)])

        rng = np.random.default_rng(1)
        jcfg, jm, jp = jax_setup("llama3-8b")
        lnp = jax.tree.map(np.asarray, jp)
        batches = [batch(rng, jcfg.vocab_size, 8, 16) for _ in range(3)]
        mcfg, mm, mp = jax_setup("phi3.5-moe-42b-a6.6b", n_groups=2)
        mnp = jax.tree.map(np.asarray, mp)
        mbatch = batch(rng, mcfg.vocab_size, 4, 16)
        masked = {}
        for arch in ("llama3-8b", "zamba2-2.7b"):
            p = bridge.params_to_numpy(build_model(R.smoke_cfg(arch), device="cpu")
                                       .init_params(torch.Generator().manual_seed(2)))
            b = dict(batch(rng, 256, 4, 16))
            b["loss_mask"] = (rng.random((4, 16)) < np.array([[0.9], [0.9], [0.2], [0.2]])
                              ).astype(np.float32)
            masked[arch] = (p, b)
        ranks = D.spawn(R.parity_rank, 2, lnp, batches, 2, mnp, mbatch, masked,
                        device="cpu", timeout=120)

        # the port's single-process step on the global batches
        cfg = R.smoke_cfg("llama3-8b")
        opt = make_optimizer("adamw")
        state = S.train_state(bridge.params_from_jax(lnp), opt)
        step = S.make_train_step(build_model(cfg, device="cpu"), opt, lambda s: R.LR,
                                 n_microbatches=2)
        single = []
        for b in batches:
            state, m = step(state, {k: torch.from_numpy(v) for k, v in b.items()})
            single.append((float(m["loss"]), float(m["grad_norm"])))
        sp = bridge.params_to_numpy(state["params"])

        # JAX's step under a (2, 1) mesh with the dry-run's ZeRO-2 grad shardings
        mesh = jax.make_mesh((2, 1), ("data", "model"),
                             axis_types=(jax.sharding.AxisType.Auto,) * 2)
        rules = dict(single_pod_rules(), fsdp=())

        def zero2(path, leaf):
            spec = [rules.get(a, ()) or None if a is not None else None
                    for a in JR.logical_spec(path, leaf, jcfg)]
            spec = _guard_divisibility(mesh, leaf.shape, P(*spec))
            spec = JR.zero1_extend(spec, leaf.shape, mesh, rules["batch"])
            return NamedSharding(mesh, _guard_divisibility(mesh, leaf.shape, spec))

        gsh = jax.tree_util.tree_map_with_path(zero2, jp)
        jopt = JO.make_optimizer("adamw")
        jstep = jax.jit(JS.make_train_step(jm, jopt, lambda s: jnp.float32(R.LR),
                                           n_microbatches=2, grad_shardings=gsh))
        js = {"params": jp, "opt": jopt.init(jp), "step": jnp.int32(0)}
        jmetrics = []
        with mesh:
            for b in batches:
                js, m = jstep(js, {k: jnp.asarray(v) for k, v in b.items()})
                jmetrics.append((float(m["loss"]), float(m["grad_norm"])))
        jpar = jax.tree.map(np.asarray, js["params"])

        res = {"single": single, "jax": jmetrics}
        for mode in ("plain", "zero"):
            r0 = ranks[0][mode]
            res[mode] = {
                "vs_single": rel(cat(r0["params"]), cat(sp)),
                "ranks_alike": bool((cat(ranks[1][mode]["params"]) == cat(r0["params"])).all()),
                "metrics": list(zip(r0["losses"], r0["norms"])),
                "held": [r[mode]["held"] for r in ranks], "whole": r0["whole"]}
        res["zero"]["vs_jax"] = {"/".join(map(str, p)): rel(a, b) for (p, a), (_, b)
                                 in zip(flatten(ranks[0]["zero"]["params"]), flatten(jpar))}

        # MoE groups: JAX's single-device loss with n_groups=2 on the whole batch
        (jl, jaux), jg = jax.value_and_grad(lambda p: (lambda o: (o[0], o[1]["aux"]))(
            mm.loss(p, {k: jnp.asarray(v) for k, v in mbatch.items()})), has_aux=True)(mp)
        jg = [np.asarray(g) for _, g in flatten(bridge.params_from_jax(
            jax.tree.map(np.asarray, jg)))]
        for mode in ("moe", "moe_per_rank"):
            rs = [r[mode] for r in ranks]
            grads = [np.mean([r["grads"][i] for r in rs], axis=0) for i in range(len(jg))]
            res[mode] = {"loss": np.mean([r["loss"] for r in rs]).item(),
                         "aux": np.mean([r["aux"] for r in rs]).item(),
                         "grads": max(rel(g, w) for g, w in zip(grads, jg))}
        res["moe_jax"] = {"loss": float(jl), "aux": float(jaux)}
        res["masked"] = {}
        for arch, (p, b) in masked.items():
            m = build_model(R.smoke_cfg(arch), device="cpu")
            whole = float(m.loss(bridge.params_from_jax(p), {k: torch.from_numpy(v)
                                                             for k, v in b.items()})[0])
            got = [r["masked"][arch] for r in ranks]
            res["masked"][arch] = {"ranks_mean": float(np.mean(got)), "whole": whole}
        print(json.dumps(res))
    """, devices=2)


# ------------------------------------------------------------- compression

def test_compressed_mean_matches_jax(compression):
    assert compression["mean_vs_jax"] <= 1e-6, compression
    assert compression["rows_alike"]


def test_compressed_residual_matches_jax(compression):
    assert compression["err_vs_jax"] <= 1e-6, compression


def test_compressed_mean_is_close_to_the_exact_mean(compression):
    assert compression["rel"] < 0.05, compression


def test_error_feedback_keeps_the_long_run_mean_unbiased(compression):
    assert compression["drift"] < compression["drift_bound"], compression


# ------------------------------------------------------------- train step

@pytest.mark.parametrize("mode", ["plain", "zero"])
def test_data_parallel_step_is_the_single_process_step(parity, mode):
    got = parity[mode]
    assert got["vs_single"] <= 1e-6, got
    assert got["ranks_alike"]
    for (loss, norm), (want_loss, want_norm) in zip(got["metrics"], parity["single"]):
        assert abs(loss - want_loss) <= 1e-5 * abs(want_loss), (loss, want_loss)
        assert abs(norm - want_norm) <= 1e-5 * abs(want_norm), (norm, want_norm)


def test_zero2_step_matches_jax_under_a_mesh(parity):
    worst = max(parity["zero"]["vs_jax"].items(), key=lambda kv: kv[1])
    assert worst[1] <= 1e-4, worst
    for (loss, norm), (want_loss, want_norm) in zip(parity["zero"]["metrics"], parity["jax"]):
        assert abs(loss - want_loss) <= 1e-5 * abs(want_loss), (loss, want_loss)
        assert abs(norm - want_norm) <= 1e-5 * abs(want_norm), (norm, want_norm)


@pytest.mark.parametrize("mode,share", [("plain", 1), ("zero", 2)])
def test_each_rank_holds_its_share_of_the_optimizer_state(parity, mode, share):
    got = parity[mode]
    assert got["held"] == [got["whole"] // share] * 2, got


# ------------------------------------------------------------- MoE groups

@pytest.mark.parametrize("key", ["loss", "aux"])
def test_moe_groups_loss_matches_jax(parity, key):
    got, want = parity["moe"][key], parity["moe_jax"][key]
    assert abs(got - want) <= 1e-5 * abs(want), (key, got, want)


def test_moe_groups_gradients_match_jax(parity):
    assert parity["moe"]["grads"] <= 1e-4, parity["moe"]


def test_per_rank_aux_means_miss_the_global_aux_loss(parity):
    """The parity test above has the power to see the trap: the product of
    per-rank means is not the product of global means."""
    got, want = parity["moe_per_rank"]["aux"], parity["moe_jax"]["aux"]
    assert abs(got - want) > 100 * 1e-5 * abs(want), (got, want)


@pytest.mark.parametrize("arch", ["llama3-8b", "zamba2-2.7b"])
def test_masked_loss_mean_is_global_under_a_group(parity, arch):
    """With a loss_mask whose weight differs between the ranks' halves, the
    mean of the ranks' losses is the whole batch's masked mean (the divisor
    is the group's summed weight)."""
    got = parity["masked"][arch]
    assert abs(got["ranks_mean"] - got["whole"]) <= 1e-6 * abs(got["whole"]), got


@pytest.fixture(scope="module")
def multi_pod():
    return _run("""
        import json
        import numpy as np
        import torch
        from repro_torch import bridge, distributed as D
        from repro_torch.models import build_model
        from repro_torch.optim.optimizers import make_optimizer
        from repro_torch.launch.mesh import Mesh
        from repro_torch.sharding.axes import multi_pod_rules
        from repro_torch.sharding.rules import model_shardings
        from repro_torch.train import steps as S
        from repro_torch.tree import leaves, unflatten_like
        import _torch_dist_ranks as R

        cfg = R.smoke_cfg("phi3.5-moe-42b-a6.6b")
        params = bridge.params_to_numpy(build_model(cfg, device="cpu").init_params(
            torch.Generator().manual_seed(4)))
        rng = np.random.default_rng(5)
        batches = []
        for _ in range(2):
            t = rng.integers(0, cfg.vocab_size, (8, 17)).astype(np.int32)
            batches.append({"tokens": t[:, :-1].copy(), "targets": t[:, 1:].copy()})
        ranks = D.spawn(R.multi_pod_rank, 4, params, batches, 2, device="cpu", timeout=120)
        opt = make_optimizer("adamw")
        # one process on the global batch, with the 4 ranks' dispatch groups
        state = S.train_state(bridge.params_from_jax(params), opt)
        step = S.make_train_step(build_model(cfg, device="cpu", n_groups=4), opt,
                                 lambda s: R.LR, n_microbatches=2)
        for b in batches:
            state, _ = step(state, {k: torch.from_numpy(v) for k, v in b.items()})
        want = np.concatenate([np.ravel(a.float().numpy()) for a in leaves(state["params"])])
        mesh = Mesh((2, 2, 1), ("pod", "data", "model"))
        sh = model_shardings(state["params"], cfg, mesh, multi_pod_rules())
        parts = [unflatten_like(state["params"], r["blocks"]) for r in ranks]
        got = np.concatenate([np.ravel(a) for a in leaves(bridge.assemble(parts, sh))])
        print(json.dumps({"rel": float(np.linalg.norm(got - want) / np.linalg.norm(want)),
                          "held": [sum(np.size(a) for a in r["blocks"]) for r in ranks],
                          "whole": int(want.size), "modes": ranks[0]["modes"]}))
    """, devices=1)


def test_zero2_step_on_a_multi_pod_mesh(multi_pod):
    """phi3.5-moe SMOKE's ZeRO-2 step on 4 ranks as (2, 2, 1) over ("pod",
    "data", "model") with the multi-pod rules, whose expert blocks split two
    dims (the experts over "data", reached by the all-to-all; d_model over
    "pod", gathered), is the single-process step with 4 dispatch groups:
    the ranks' blocks put together within 1e-6 relative L2 over every
    param. The experts' blocks are each rank's own ("own": no ZeRO
    collective moves them), so each rank holds less than the whole."""
    assert "own" in multi_pod["modes"], multi_pod
    assert multi_pod["rel"] <= 1e-6, multi_pod
    assert max(multi_pod["held"]) < multi_pod["whole"], multi_pod


def test_build_model_n_groups_matches_jax():
    """`build_model(cfg, n_groups=2)` in one process, phi3.5-moe SMOKE in
    fp32, against JAX's with the same groups: the loss, the aux loss and
    the prefill's last logits within 1e-5 (the tolerance of
    tests/test_torch_moe.py)."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    import torch
    from repro.configs import get_config as jget
    from repro.models import build_model as jbuild
    from repro_torch import bridge
    from repro_torch.configs import get_config
    from repro_torch.models import build_model

    jcfg = jget("phi3.5-moe-42b-a6.6b", smoke=True).replace(param_dtype="float32")
    jm = jbuild(jcfg, n_groups=2)
    jp = jm.init_params(jax.random.PRNGKey(3))
    m = build_model(get_config("phi3.5-moe-42b-a6.6b", smoke=True)
                    .replace(param_dtype="float32"), device="cpu", n_groups=2)
    p = bridge.params_from_jax(jp)
    t = np.random.default_rng(4).integers(0, jcfg.vocab_size, (4, 17)).astype(np.int32)
    batch = {"tokens": t[:, :-1], "targets": t[:, 1:]}
    jloss, jmetrics = jm.loss(jp, {k: jnp.asarray(v) for k, v in batch.items()})
    with torch.no_grad():
        loss, metrics = m.loss(p, {k: torch.from_numpy(v.copy()) for k, v in batch.items()})
        logits, _ = m.prefill(p, {"tokens": torch.from_numpy(batch["tokens"].copy())})
    jlogits, _ = jm.prefill(jp, {"tokens": jnp.asarray(batch["tokens"])})
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    np.testing.assert_allclose(float(metrics["aux"]), float(jmetrics["aux"]), rtol=1e-5)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), atol=1e-5, rtol=1e-5)


def test_ranks_run_job_after_job_in_the_same_processes():
    """`Ranks` keeps its processes and group from one job to the next, and
    `spawn` is one job on fresh ranks: the same sums either way."""
    from repro_torch import distributed as D
    import _torch_dist_ranks as R
    with D.Ranks(2, device="cpu", timeout=60) as ranks:
        first = ranks.run(R.pid_sum_rank, 1)
        second = ranks.run(R.pid_sum_rank, 10)
    assert [pid for pid, _ in first] == [pid for pid, _ in second]
    assert [v for _, v in first] == [3.0, 3.0] and [v for _, v in second] == [21.0, 21.0]
    fresh = D.spawn(R.pid_sum_rank, 2, 1, device="cpu", timeout=60)
    assert [v for _, v in fresh] == [3.0, 3.0]
    assert {pid for pid, _ in fresh}.isdisjoint(pid for pid, _ in first)


def test_ranks_raise_a_rank_s_error_and_stop():
    """A job that raises on one rank makes `run` raise with that rank's
    traceback, and the ranks are stopped: no further job runs."""
    from repro_torch import distributed as D
    import _torch_dist_ranks as R
    ranks = D.Ranks(2, device="cpu", timeout=60)
    with pytest.raises(RuntimeError, match="rank 1 raises"):
        ranks.run(R.raising_rank)
    with pytest.raises(RuntimeError, match="closed"):
        ranks.run(R.pid_sum_rank, 1)


@pytest.mark.parametrize("world", [2, 4])
def test_gloo_rings_are_gloo_s_collectives(world):
    """Under gloo, `reduce_scatter_` and `all_gather_` run as rings of
    point-to-point hops: the same sums as gloo's `reduce_scatter_tensor`
    (bit for bit over 2 ranks, whose sum has one order; within fp32
    rounding over 4), the same gather bit for bit, and the same cost
    account as the c10d ops they stand for."""
    import numpy as np
    from repro_torch import distributed as D
    import _torch_dist_ranks as R
    x = np.random.default_rng(7).standard_normal((world, world * 3, 5)).astype(np.float32)
    res = D.spawn(R.ring_collectives_rank, world, x, device="cpu", timeout=120)
    whole = x.sum(0)
    for rank, r in enumerate(res):
        (rs, rg, rc, rop, rb), (gs, gg, gc, gop, gb) = r["ring"], r["gloo"]
        np.testing.assert_allclose(rs, whole[3 * rank:3 * rank + 3], rtol=1e-6, atol=1e-6)
        if world == 2:
            np.testing.assert_array_equal(rs, gs)
        else:
            np.testing.assert_allclose(rs, gs, rtol=1e-6, atol=1e-6)
        np.testing.assert_array_equal(rg, np.concatenate([q["ring"][0] for q in res]))
        # gloo's own ops add copies of their own on the CPU (no card's
        # account sees them): the rings' account is the c10d ops' alone
        assert rc == gc
        ops = ("c10d::_reduce_scatter_base_", "c10d::_allgather_base_")
        assert {k: v for k, v in rop.items() if k.startswith("c10d::")} == \
            {k: gop[k] for k in ops}
        assert rb == sum(gop[k][2] for k in ops)
        assert rc["reduce-scatter"][0] == 1 and rc["all-gather"][0] == 1

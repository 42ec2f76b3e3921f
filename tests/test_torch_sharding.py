"""The port's sharding rules (sharding/axes.py, sharding/rules.py) against the
JAX package's, and the checkpointer's resharded restore.

Specs. For every config at full size, on the production meshes (16, 16)
over ("data", "model") with the single-pod rules and (2, 16, 16) over
("pod", "data", "model") with the multi-pod rules, the port's spec of every
leaf of its stacked view equals the reference's: `param_pspecs`, the guarded
spec (`_guard_divisibility`) and the dry-run's ZeRO-1 extension
(`zero1_extend`, guarded again). JAX's mesh functions read only
`mesh.axis_names` and `mesh.devices.shape`, so a stand-in with those two
fields serves, in process. Param shapes come from `jax.eval_shape` on the
JAX side and from the meta device on the port's. Where a ZeRO spec puts the
DP axes on a stacked axis, the port's `Shardings.index` makes each rank the
owner of whole items of its lists, the items that the reference's block of
the stacked array holds. Specs compare entry by entry, a one-name tuple
equal to the bare name (jax.sharding.PartitionSpec makes them one).

The resharded restore runs in a subprocess, its ranks gloo processes on the
CPU (`repro_torch.distributed.spawn`): JAX's
`test_checkpoint_restore_resharded` case (arange(64) as (8, 8), saved 8 ways
on "d", restored under a (4, 2) mesh as ("m", "d")); and a ZeRO-2 train
state of llama3-8b SMOKE saved at W=4, restored at W=2 (the DP axes moved
off the layer axis onto an inner dim) and at W=1: every value bit-identical
to the checkpoint, every block the one asked for; a W=4 run resumed from the
checkpoint ends bit-identical to the straight W=4 run.
"""
import functools
import types

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import build_model as jax_build_model
from repro.optim import optimizers as JO
from repro.sharding import axes as JA
from repro.sharding import rules as JR
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.launch.mesh import Mesh, dp_degree
from repro_torch.models import build_model
from repro_torch.optim import optimizers as O
from repro_torch.sharding import axes as A
from repro_torch.sharding import rules as R
from repro_torch.tree import flatten

import _torch_subproc as subproc

MESHES = {"single_pod": ((16, 16), ("data", "model"), A.single_pod_rules,
                         JA.single_pod_rules),
          "multi_pod": ((2, 16, 16), ("pod", "data", "model"), A.multi_pod_rules,
                        JA.multi_pod_rules)}


def _jax_mesh(shape, axes):
    return types.SimpleNamespace(axis_names=axes, devices=np.empty(shape, dtype=np.int8))


def _canon(spec, ndim):
    out = [e[0] if isinstance(e, tuple) and len(e) == 1 else e for e in tuple(spec)]
    return tuple(out + [None] * (ndim - len(out)))


def _jax_leaves(tree):
    return {tuple(str(e.key) for e in path): leaf
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


@functools.cache
def _jax_params(arch):
    cfg = jax_get_config(arch)
    return cfg, jax.eval_shape(jax_build_model(cfg).init_params, jax.random.PRNGKey(0))


@functools.cache
def _port_params(arch):
    cfg = get_config(arch)
    return cfg, build_model(cfg, device="meta").init_params(torch.Generator())


def _specs_both(arch, mesh_name, kind):
    """(port, jax) spec of every stacked leaf: kind "param" (param_pspecs),
    "guarded" or "zero1" (the dry-run's _leaf_sharding)."""
    shape, axes, rules, jrules = MESHES[mesh_name]
    jcfg, jshapes = _jax_params(arch)
    cfg, params = _port_params(arch)
    jmesh, mesh = _jax_mesh(shape, axes), Mesh(shape, axes)
    jparam = _jax_leaves(JR.param_pspecs(jshapes, jcfg, jrules()))
    jleaves = _jax_leaves(jshapes)
    view = R.stacked_view(params)
    assert {p: s.shape for p, s in view.items()} == \
        {p: tuple(l.shape) for p, l in jleaves.items()}
    if kind == "param":
        port = R.param_specs(view, cfg, rules())
        return ({p: _canon(s, len(view[p].shape)) for p, s in port.items()},
                {p: _canon(s, len(jleaves[p].shape)) for p, s in jparam.items()})
    dp = jrules()["batch"]
    want = {}
    for p, leaf in jleaves.items():
        s = JA._guard_divisibility(jmesh, leaf.shape, jparam[p])
        if kind == "zero1":
            s = JA._guard_divisibility(jmesh, leaf.shape,
                                       JR.zero1_extend(s, leaf.shape, jmesh, dp))
        want[p] = _canon(s, len(leaf.shape))
    got = {p: _canon(R.leaf_spec(p, s, cfg, mesh, rules(), dp, kind == "zero1"), len(s.shape))
           for p, s in view.items()}
    return got, want


@pytest.mark.parametrize("kind", ["param", "guarded", "zero1"])
@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_specs_match_jax(arch, mesh_name, kind):
    got, want = _specs_both(arch, mesh_name, kind)
    assert got.keys() == want.keys()
    bad = {p: (got[p], want[p]) for p in want if got[p] != want[p]}
    assert not bad, bad


def _expected_items(spec, shape, depth, mesh, coord):
    """The items of a stack (index tuples) and their inner blocks that the
    reference's block of the stacked array holds at `coord`, computed from
    the spec with JAX's layout: a dim over axes (a, b) cut into size(a) *
    size(b) parts, taken row-major over the axes."""
    sizes, pos = dict(zip(mesh.axis_names, mesh.shape)), dict(zip(mesh.axis_names, coord))
    ranges = []
    for dim, e in zip(shape, spec):
        axes = () if e is None else (e if isinstance(e, tuple) else (e,))
        n = int(np.prod([sizes[a] for a in axes]))
        k = int(np.ravel_multi_index([pos[a] for a in axes], [sizes[a] for a in axes])) \
            if axes else 0
        ranges.append((k * dim // n, (k + 1) * dim // n))
    return ranges[:depth], ranges[depth:]


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_zero1_layer_ownership(arch, mesh_name):
    """Each rank's blocks of the port's per-layer leaves are the items and
    inner blocks of its block of the reference's stacked leaf."""
    shape, axes, rules, jrules = MESHES[mesh_name]
    cfg, params = _port_params(arch)
    mesh = Mesh(shape, axes)
    sh = R.shardings_for(params, cfg, mesh, rules(), zero1=True)
    view = R.stacked_view(params)
    paths = [path for path, _ in flatten(params)]
    owners = 0
    for rank in (0, 1, mesh.size // 2 + 3, mesh.size - 1):
        coord = R.coordinate(mesh, rank)
        assert coord == np.unravel_index(rank, shape)
        for path, b in zip(paths, sh.index(params, rank)):
            spath, idx = R.split_path(path)
            leaf = view[spath]
            stack, inner = _expected_items(_canon(sh.specs[spath], len(leaf.shape)), leaf.shape,
                                           leaf.depth, mesh, coord)
            if all(lo <= i < hi for i, (lo, hi) in zip(idx, stack)):
                assert b is not None and [(s.start, s.stop) for s in b] == inner, (path, b)
                owners += bool(idx)
            else:
                assert b is None, (path, rank)
    assert owners > 0


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_adafactor_state_specs_match_jax(arch):
    """The port's Adafactor state, per layer and stacked (`_stacked`), seen
    stacked, has the reference's leaves and ZeRO-1 specs."""
    shape, axes, rules, jrules = MESHES["single_pod"]
    jcfg, jshapes = _jax_params(arch)
    cfg, params = _port_params(arch)
    jstate = _jax_leaves(jax.eval_shape(JO.make_optimizer("adafactor").init, jshapes)["s"])
    view = R.stacked_view(O.adafactor().init(params)["s"])
    assert {p: s.shape for p, s in view.items()} == \
        {p: tuple(l.shape) for p, l in jstate.items()}
    jmesh, mesh = _jax_mesh(shape, axes), Mesh(shape, axes)
    for p, s in view.items():
        want = JA._guard_divisibility(jmesh, s.shape, JR.zero1_extend(
            JA._guard_divisibility(jmesh, s.shape, JR.param_pspecs(
                {"x": jstate[p]}, jcfg, jrules())["x"]), s.shape, jmesh, jrules()["batch"]))
        got = R.leaf_spec(p, s, cfg, mesh, rules(), rules()["batch"], True)
        assert _canon(got, len(s.shape)) == _canon(want, len(s.shape)), p


# ------------------------------------------------------------- axes.py

def test_resolve_binds_logical_axes_in_scope():
    mesh = Mesh((2, 4), ("data", "model"))
    assert A.resolve(("batch", None)) is None
    with A.axis_rules(mesh, A.single_pod_rules()):
        assert A.resolve(("batch", None, "model", ("batch", "model"), "seq")) == \
            (("data",), None, ("model",), ("data", "model"), None)
        with JA.axis_rules(_jax_mesh((2, 4), ("data", "model")), JA.single_pod_rules()):
            want = JA.resolve(("batch", None, "model", ("batch", "model"), "seq"))
        assert _canon(A.resolve(("batch", None, "model", ("batch", "model"), "seq")), 5) == \
            _canon(want, 5)
    assert A.resolve(("batch",)) is None


@pytest.mark.parametrize("shape,spec", [
    ((8, 6), ("data", "model")), ((6, 12), (("data", "model"), None)),
    ((8,), (("model", "data"),)), ((4, 3, 16), (None, "model", ("pod", "data")))])
def test_guard_divisibility_matches_jax(shape, spec):
    """A bare axis stays bare, a tuple a tuple, and an axis that does not
    divide its dim is dropped, as the reference's guard does."""
    mesh_shape, axes = (2, 2, 4), ("pod", "data", "model")
    got = A.guard_divisibility(Mesh(mesh_shape, axes), shape, spec)
    want = JA._guard_divisibility(_jax_mesh(mesh_shape, axes), shape,
                                  jax.sharding.PartitionSpec(*spec))
    assert _canon(got, len(shape)) == _canon(want, len(shape))
    for g, s in zip(got, spec):
        assert g is None or isinstance(g, tuple) == isinstance(s, tuple)


def test_placements_and_blocks_of_a_spec():
    mesh = Mesh((4, 2), ("d", "m"))
    assert [str(p) for p in R.placements(("m", "d"), mesh)] == ["S(1)", "S(0)"]
    assert [str(p) for p in R.placements((None, "m"), mesh)] == ["R", "S(1)"]
    # rank 5 sits at (2, 1): rows half 1 of 2, columns quarter 2 of 4
    assert R.coordinate(mesh, 5) == (2, 1)
    assert R.block((8, 8), ("m", "d"), mesh, (2, 1)) == (slice(4, 8), slice(4, 6))
    assert R.block((8, 8), (("d", "m"), None), mesh, (2, 1)) == (slice(5, 6), slice(0, 8))
    assert dp_degree(Mesh((2, 16, 16), ("pod", "data", "model"))) == 32


# ------------------------------------------------------------- resharded restore

@pytest.fixture(scope="module")
def restore(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("ckpt"))
    script = f"""
        import json, os
        import numpy as np
        import torch
        from repro_torch import bridge, distributed as D
        from repro_torch.checkpoint.checkpointer import Checkpointer
        from repro_torch.models import build_model
        from repro_torch.optim.optimizers import make_optimizer
        from repro_torch.train.steps import train_state
        from repro_torch.tree import flatten
        import _torch_dist_ranks as R

        tmp = {tmp!r}
        arange = D.spawn(R.restore_arange_rank, 8, os.path.join(tmp, "arange"), device="cpu",
                         timeout=120)
        cfg = R.smoke_cfg("llama3-8b")
        params = bridge.params_to_numpy(build_model(cfg, device="cpu").init_params(
            torch.Generator().manual_seed(0)))
        rng = np.random.default_rng(3)
        batches = []
        for _ in range(3):
            t = rng.integers(0, cfg.vocab_size, (8, 17)).astype(np.int32)
            batches.append({{"tokens": t[:, :-1].copy(), "targets": t[:, 1:].copy()}})
        straight, resumed = os.path.join(tmp, "straight"), os.path.join(tmp, "resumed")
        D.spawn(R.dp_resume_rank, 4, "llama3-8b", params, batches, 2, straight, resumed,
                device="cpu", timeout=120)
        w2 = D.spawn(R.dp_restore_rank, 2, "llama3-8b", params, straight, 2, device="cpu",
                     timeout=120)
        opt = make_optimizer("adamw")
        whole = train_state(build_model(cfg, device="cpu").init_params(torch.Generator()), opt)
        Checkpointer(straight).restore(whole, step=2)

        def saved(d, step):
            cdir = os.path.join(d, f"step_{{step:010d}}")
            m = json.load(open(os.path.join(cdir, "manifest.json")))
            return {{k: np.load(os.path.join(cdir, v["file"])) for k, v in m["leaves"].items()}}

        ck2, ck3, re3 = saved(straight, 2), saved(straight, 3), saved(resumed, 3)
        res = {{"arange": [{{k: (v.tolist() if isinstance(v, np.ndarray) else v)
                            for k, v in r.items()}} for r in arange]}}
        res["resumed_equal"] = sorted(ck3) == sorted(re3) and all(
            np.array_equal(ck3[k], re3[k]) for k in ck3)
        res["whole_shapes"] = {{"/".join(map(str, p)): list(t.shape)
                               for p, t in flatten(whole)}} == \\
            {{k: list(v.shape) for k, v in ck2.items()}}
        res["w1_equal"] = all(np.array_equal(
            t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy(),
            ck2["/".join(map(str, p))]) for p, t in flatten(whole))
        for stack in ("True", "False"):
            bad, blocks = [], {{}}
            for got in w2:
                for key, (b, arr) in got[stack].items():
                    blocks.setdefault(key, []).append(b)
                    if b is None:
                        assert arr.size == 0, key
                    elif not np.array_equal(arr, ck2[key][tuple(slice(*s) for s in b)]):
                        bad.append(key)
            res[f"w2_{{stack}}"] = {{"bad": bad, "blocks": blocks}}
        print(json.dumps(res))
    """
    return subproc.run(script)


def test_restore_resharded_arange_values(restore):
    w = np.arange(64.0).reshape(8, 8)
    for r in restore["arange"]:
        (r0, r1), (c0, c1) = r["rows"], r["cols"]
        np.testing.assert_array_equal(np.asarray(r["got"]), w[r0:r1, c0:c1])


def test_restore_resharded_arange_blocks_as_asked(restore):
    """("m", "d") on a (4, 2) mesh over ("d", "m"): rows split over m,
    columns over d; placements S(1) on d and S(0) on m."""
    for rank, r in enumerate(restore["arange"]):
        d, m = divmod(rank, 2)
        assert r["rows"] == [4 * m, 4 * m + 4] and r["cols"] == [2 * d, 2 * d + 2]
        assert r["placements"] == ["S(1)", "S(0)"]


def test_sharded_save_writes_the_whole_state(restore):
    assert restore["whole_shapes"]


def test_restore_at_one_rank_is_bit_identical(restore):
    assert restore["w1_equal"]


@pytest.mark.parametrize("stack", ["True", "False"])
def test_restore_at_two_ranks_is_bit_identical(restore, stack):
    assert restore[f"w2_{stack}"]["bad"] == []


def test_restore_at_two_ranks_places_blocks_as_asked(restore):
    """With the DP axes on the layer axis each rank owns one of the two
    layers' moments whole; moved off it, each rank holds half of every
    layer's moments, split on the first inner dim that 2 divides."""
    own, split = restore["w2_True"]["blocks"], restore["w2_False"]["blocks"]
    wq = "opt/m/layers/{}/attn/wq"
    assert own[wq.format(0)] == [[[0, 64], [0, 64]], None]
    assert own[wq.format(1)] == [None, [[0, 64], [0, 64]]]
    for i in (0, 1):
        assert split[wq.format(i)] == [[[0, 32], [0, 64]], [[32, 64], [0, 64]]]
    assert own["params/layers/0/attn/wq"] == [[[0, 64], [0, 64]]] * 2


def test_resumed_run_continues_bit_identically(restore):
    assert restore["resumed_equal"]

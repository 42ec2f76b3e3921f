"""The port's RL rollout unit (src/repro_torch/rl/envs.py and rollout.py)
against the JAX package's (src/repro/rl/), on the CPU.

Both sides take the same inputs: states and actions drawn with numpy from a
seed, the reference's policy weights and initial states (from the same
`jax.random.split` its `make_rollout_fn` uses) handed over by
`repro_torch.bridge`, and, for a MuJoCo surrogate, the reference's own
matrices. The reference seeds those with `hash(spec.name)`, which Python
salts per process, so the test derives them in this process with the
reference's own key formula and hands them to the port. Tolerances, with
their reasons (all fp32):
  * one classic-control step: atol=rtol=1e-5 (sin and cos of another
    library, and Acrobot's divisions, a few ulps apart);
  * one surrogate step and `policy_apply`: atol=rtol=1e-5 (matrix products
    summed in another order, through tanh);
  * `orthogonal` on the reference's normal draw: atol=1e-5 (QR of another
    library);
  * 64-step trajectories of Pendulum and the surrogates, run free:
    observations and rewards to atol=rtol=1e-4 (a step's rounding carried
    through 64 steps of a contracting map);
  * Cartpole and Acrobot, whose argmax near a tie can flip and then send
    the run elsewhere: step by step from the reference's states, the
    action equal wherever the reference's top two logits are more than
    TIE apart, and the next state and observation to 1e-5; the free-running
    trajectories are compared too, up to the first step whose action the
    reference took within TIE of a tie.
"""
import math
import runpy
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.rl import envs as JE
from repro.rl import rollout as JR
from repro_torch import bridge
from repro_torch.rl import envs as E
from repro_torch.rl import rollout as R

STEP_TOL = dict(atol=1e-5, rtol=1e-5)
TRAJ_TOL = dict(atol=1e-4, rtol=1e-4)
TIE = 1e-4
CLASSIC = ["Cartpole", "Pendulum", "Acrobot"]
SURROGATES = [n for n, s in JE.ENV_SPECS.items() if s.surrogate_dim]


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _jax_matrices(spec):
    """The reference's surrogate matrices, by its own key formula (the same
    `hash` in this process as in JE.surrogate_step_fn)."""
    key = jax.random.PRNGKey(hash(spec.name) % (2 ** 31))
    n = spec.surrogate_dim
    W = jax.random.orthogonal(key, n) * 0.99
    Pobs = jax.random.normal(jax.random.fold_in(key, 1), (n, spec.obs_dim)) / math.sqrt(n)
    Pact = jax.random.normal(jax.random.fold_in(key, 2), (spec.act_dim, n)) / math.sqrt(n)
    return tuple(np.asarray(m) for m in (W, Pobs, Pact))


def _port_env(name):
    """The port's (spec, step) of `name`, a surrogate given the reference's
    matrices."""
    spec = E.ENV_SPECS[name]
    if spec.surrogate_dim:
        return spec, E.surrogate_step_fn(spec, matrices=bridge.surrogate_matrices_from_numpy(
            _jax_matrices(spec)), device="cpu")
    return spec, {"Cartpole": E.cartpole_step, "Pendulum": E.pendulum_step,
                  "Acrobot": E.acrobot_step}[name]


# ---------------------------------------------------------------- the specs

def test_env_specs_are_the_reference_s():
    assert list(E.ENV_SPECS) == list(JE.ENV_SPECS)
    assert len(E.ENV_SPECS) == 14
    for name, spec in JE.ENV_SPECS.items():
        assert E.ENV_SPECS[name].__dict__ == spec.__dict__, name
    assert E._PAPER_28CPU == JE._PAPER_28CPU


# ---------------------------------------------------------------- one step

def _classic_inputs(name, n=64, seed=0):
    rng = np.random.default_rng(seed)
    if name == "Cartpole":
        states = rng.uniform(-0.3, 0.3, (n, 4))
        actions = rng.integers(0, 2, n)
    elif name == "Pendulum":
        th = rng.uniform(-2 * np.pi, 2 * np.pi, n)
        # angles at and around the wrap of the cost's floor modulo
        edge = np.array([np.pi, -np.pi, 3 * np.pi, -3 * np.pi])
        th[:16] = np.repeat(edge, 4) + np.tile([0.0, 1e-6, -1e-6, 1e-3], 4)
        states = np.stack([th, rng.uniform(-8, 8, n)], -1)
        actions = rng.uniform(-3, 3, (n, 1))
    else:
        states = np.concatenate([rng.uniform(-np.pi, np.pi, (n, 2)),
                                 rng.uniform(-4 * np.pi, 4 * np.pi, (n, 1)),
                                 rng.uniform(-9 * np.pi, 9 * np.pi, (n, 1))], -1)
        actions = rng.integers(0, 3, n)
    dt = np.float32 if name == "Pendulum" else np.int32
    return states.astype(np.float32), actions.astype(dt)


@pytest.mark.parametrize("name", CLASSIC)
def test_classic_control_step_matches_jax(name):
    """Seeded random states and actions, each through both steps; Pendulum
    also at angles on and next to +-pi and +-3pi, where the cost's angle
    wraps."""
    jstep = {"Cartpole": JE.cartpole_step, "Pendulum": JE.pendulum_step,
             "Acrobot": JE.acrobot_step}[name]
    _, step = _port_env(name)
    states, actions = _classic_inputs(name)
    for s, a in zip(states, actions):
        want = jstep(jnp.asarray(s), jnp.asarray(a))
        got = step(torch.from_numpy(s), torch.from_numpy(np.array(a)))
        for what, g, w in zip(("state", "obs", "reward"), got, want):
            np.testing.assert_allclose(_np(g), np.asarray(w, np.float32), err_msg=what,
                                       **STEP_TOL)
        assert bool(got[3]) == bool(want[3])


@pytest.mark.parametrize("name", SURROGATES)
def test_surrogate_step_matches_jax(name):
    """The reference's matrices handed to the port: one step of seeded
    states and actions."""
    spec = JE.ENV_SPECS[name]
    jstep = JE.surrogate_step_fn(spec)
    _, step = _port_env(name)
    rng = np.random.default_rng(1)
    for _ in range(4):
        s = (rng.standard_normal(spec.surrogate_dim) * 0.3).astype(np.float32)
        a = np.tanh(rng.standard_normal(spec.act_dim)).astype(np.float32)
        want = jstep(jnp.asarray(s), jnp.asarray(a))
        got = step(torch.from_numpy(s), torch.from_numpy(a))
        for what, g, w in zip(("state", "obs", "reward"), got, want):
            assert tuple(g.shape) == tuple(w.shape), what
            np.testing.assert_allclose(_np(g), np.asarray(w), err_msg=what, **STEP_TOL)
        assert not bool(got[3])


@pytest.mark.parametrize("n", [16, 256])
def test_orthogonal_matches_jax_on_the_same_draw(n):
    """jax.random.orthogonal's construction on its own normal draw."""
    key = jax.random.PRNGKey(n)
    z = np.array(jax.random.normal(key, (n, n)))
    got = E.orthogonal(torch.from_numpy(z))
    np.testing.assert_allclose(_np(got), np.asarray(jax.random.orthogonal(key, n)), atol=1e-5,
                               rtol=0)


def test_surrogate_matrices_are_stable_across_calls():
    """Seeded from the name by crc32 (not the per-process `hash`): the same
    matrices on every call; W orthogonal times 0.99; each env its own seed."""
    spec = E.ENV_SPECS["Hopper"]
    W, Pobs, Pact = E.surrogate_matrices(spec)
    for a, b in zip((W, Pobs, Pact), E.surrogate_matrices(spec)):
        assert torch.equal(a, b)
    assert (W.shape, Pobs.shape, Pact.shape) == ((64, 64), (64, 11), (3, 64))
    torch.testing.assert_close(W @ W.T, 0.99 ** 2 * torch.eye(64), atol=1e-5, rtol=0)
    assert E.surrogate_seed("Hopper") != E.surrogate_seed("Walker2d")


def test_policy_apply_matches_jax():
    key = jax.random.PRNGKey(3)
    jp = JR.init_policy(key, 17, 6)
    p = bridge.policy_from_jax(jax.tree.map(np.asarray, jp))
    obs = np.random.default_rng(2).standard_normal((5, 17)).astype(np.float32)
    np.testing.assert_allclose(_np(R.policy_apply(p, torch.from_numpy(obs))),
                               np.asarray(JR.policy_apply(jp, jnp.asarray(obs))), **STEP_TOL)
    assert {k: tuple(v.shape) for k, v in p.items()} == \
        {"w1": (17, 64), "w2": (64, 64), "w3": (64, 6)}


# ---------------------------------------------------------------- trajectories

def _jax_run(name, key, n_steps):
    """The reference's rollout of `key`, with the states, logits and actions
    it passes through; and the params and initial state it drew."""
    spec, init_fn, step_fn = JE.make_env(name)
    act_out = spec.n_actions if spec.n_actions else spec.act_dim
    kp, ke = jax.random.split(key)
    params = JR.init_policy(kp, spec.obs_dim, act_out)
    state0 = init_fn(ke)

    def step(carry, _):
        state, obs = carry
        logits = JR.policy_apply(params, obs)
        action = jnp.argmax(logits) if spec.n_actions else jnp.tanh(logits)
        new_state, new_obs, reward, _ = step_fn(state, action)
        return (new_state, new_obs), (state, obs, logits, action, new_state, new_obs, reward)

    _, trace = jax.lax.scan(step, (state0, jnp.zeros((spec.obs_dim,))), None, length=n_steps)
    return params, state0, [np.array(t) for t in trace]


def _port_rollout(name, monkeypatch, n_steps):
    """The port's make_rollout_fn on the CPU, a surrogate with the
    reference's matrices."""
    spec, step = _port_env(name)
    real = R.make_env

    def make_env(env_name, device):
        s, init_fn, _ = real(env_name, device=device)
        return s, init_fn, step
    monkeypatch.setattr(R, "make_env", make_env)
    return R.make_rollout_fn(name, n_steps, device="cpu")


@pytest.mark.parametrize("name", ["Pendulum"] + SURROGATES)
def test_trajectory_matches_jax(name, monkeypatch):
    """JAX's make_rollout_fn(name, 64)(PRNGKey(s)) against the port's core
    fed the same `init_policy(kp)` and `init_fn(ke)`."""
    n_steps = 64
    for s in (0, 1):
        key = jax.random.PRNGKey(s)
        jfn, spec = JR.make_rollout_fn(name, n_steps)
        jobs, jrew = jfn(key)
        params, state0, _ = _jax_run(name, key, n_steps)
        fn, pspec = _port_rollout(name, monkeypatch, n_steps)
        assert pspec == E.ENV_SPECS[name]
        obs, rew = fn.core(bridge.policy_from_jax(jax.tree.map(np.asarray, params)),
                           torch.from_numpy(np.array(state0)))
        assert tuple(obs.shape) == (n_steps, spec.obs_dim) and tuple(rew.shape) == (n_steps,)
        np.testing.assert_allclose(_np(obs), np.asarray(jobs), err_msg="obs", **TRAJ_TOL)
        np.testing.assert_allclose(_np(rew), np.asarray(jrew), err_msg="reward", **TRAJ_TOL)


@pytest.mark.parametrize("name", ["Cartpole", "Acrobot"])
def test_discrete_trajectory_matches_jax_step_by_step(name, monkeypatch):
    """Each step of the reference's 64-step run replayed by the port from the
    reference's state and observation: the policy's action (equal where the
    reference's top two logits are more than TIE apart), then the env's
    step on the reference's action. The free run agrees up to the first
    near-tie."""
    n_steps = 64
    _, step = _port_env(name)
    for s in (0, 1, 2):
        key = jax.random.PRNGKey(s)
        jobs, _ = JR.make_rollout_fn(name, n_steps)[0](key)
        params, state0, (states, obs, logits, actions, nstates, nobs, rewards) = \
            _jax_run(name, key, n_steps)
        np.testing.assert_array_equal(nobs, np.asarray(jobs))   # the same run as the reference's
        p = bridge.policy_from_jax(jax.tree.map(np.asarray, params))
        ties = []
        for t in range(n_steps):
            lg = R.policy_apply(p, torch.from_numpy(obs[t]))
            np.testing.assert_allclose(_np(lg), logits[t], **STEP_TOL)
            top2 = np.sort(logits[t])[-2:]
            if top2[1] - top2[0] > TIE:
                assert int(torch.argmax(lg)) == int(actions[t]), (s, t)
            else:
                ties.append(t)
            got = step(torch.from_numpy(states[t]), torch.as_tensor(actions[t]))
            np.testing.assert_allclose(_np(got[0]), nstates[t], err_msg=f"state {t}", **STEP_TOL)
            np.testing.assert_allclose(_np(got[1]), nobs[t], err_msg=f"obs {t}", **STEP_TOL)
            np.testing.assert_allclose(_np(got[2]), rewards[t], **STEP_TOL)
        fn, _ = _port_rollout(name, monkeypatch, n_steps)
        free, _ = fn.core(p, torch.from_numpy(np.array(state0)))
        upto = ties[0] if ties else n_steps
        np.testing.assert_allclose(_np(free)[:upto], nobs[:upto], **TRAJ_TOL)


# ------------------------------------- the port of tests/test_substrate.py's RL tests

def test_classic_control_dynamics():
    s = torch.tensor([0.0, 0.0, 0.05, 0.0])
    s2, obs, r, done = E.cartpole_step(s, torch.tensor(1))
    assert not bool(done) and float(r) == 1.0
    assert abs(float(s2[1])) > 0.0      # force accelerates the cart
    st = torch.tensor([0.1, 0.0])
    _, obs, r, _ = E.pendulum_step(st, torch.tensor([0.5]))
    assert obs.shape == (3,) and float(r) <= 0.0


def test_rollout_task_artifact_sizes():
    r = R.rollout_task("Pendulum", 50, seed=0, device="cpu")
    assert r["interactions"] == 50
    assert r["obs"].shape == (50, E.ENV_SPECS["Pendulum"].obs_dim)
    assert r["obs"].dtype == np.float32 and np.isfinite(r["reward_sum"])
    h = R.rollout_task("Humanoid", 10, seed=0, device="cpu")
    assert h["obs"].shape == (10, 376)   # the fat artifact (paper's collapse)
    # the reward sum is the trajectory's, read back with it
    fn, _ = R.make_rollout_fn("Pendulum", 50, device="cpu")
    obs, rew = fn(0)
    np.testing.assert_array_equal(r["obs"], _np(obs))
    assert r["reward_sum"] == float(rew.sum())


def test_rollouts_on_cluster():
    from repro.core import SyndeoCluster
    with SyndeoCluster() as c:
        for _ in range(2):
            c.add_worker()
        tput, stats = R.run_benchmark_local(c, "Cartpole", n_workers=2,
                                            steps_per_worker=100, device="cpu")
        assert tput > 0 and stats["n_tasks"] == 2


def test_entry_points_default_to_the_card(monkeypatch):
    """Without a card, the default device raises instead of running on the
    CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: R.rollout_task("Cartpole", 4, 0),
                 lambda: R.make_rollout_fn("Humanoid", 4),
                 lambda: E.make_env("Pendulum"),
                 lambda: R.init_policy(torch.Generator(), 3, 1)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


# ---------------------------------------------------------------- the example

def test_rl_rollout_torch_example_runs_on_the_cpu(monkeypatch, capsys):
    """examples/rl_rollout_torch.py on repro.core.SyndeoCluster, on the CPU
    when asked (without a card its default, the card, raises)."""
    example = Path(__file__).resolve().parents[1] / "examples" / "rl_rollout_torch.py"
    monkeypatch.setattr(sys, "argv", ["rl_rollout_torch.py", "--env", "Hopper", "--steps", "20",
                                      "--device", "cpu"])
    runpy.run_path(str(example), run_name="__main__")
    out = capsys.readouterr().out
    assert "Hopper on cpu" in out and "interactions/s over 2 actors" in out

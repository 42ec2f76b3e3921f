"""RL rollout actors: the paper's benchmark workload on the Syndeo runtime,
the port of the JAX package's `rl/rollout.py`.

Each actor hosts one environment and a fully-connected policy network and
collects state-action interactions (paper §IV). `rollout_task` is the unit
of work the Syndeo scheduler dispatches; `run_benchmark_local` drives real
rollouts through a cluster the caller hands over (the JAX package's
threaded `repro.core.SyndeoCluster`, or anything with its `submit` and
`wait_all`), so this package imports nothing of the JAX package.

The reference jits a `lax.scan` over the steps. Here the loop runs eagerly
on the device under `torch.no_grad()`: each step is a few dozen small
launches and no host read, and the trajectory is read back once, at the end.
"""
from __future__ import annotations

import math
import time
from typing import Callable, Dict, Tuple

import torch

from repro_torch.device import resolve_device
from repro_torch.rl.envs import EnvSpec, make_env

F32 = torch.float32


def init_policy(generator: torch.Generator, obs_dim: int, act_out: int, hidden: int = 64,
                device="cuda") -> Dict[str, torch.Tensor]:
    """The MLP's three weights, normal / sqrt(fan-in), drawn from `generator`
    (which must live on `device`)."""
    dev = resolve_device(device)

    def w(fan_in, fan_out):
        return torch.randn((fan_in, fan_out), generator=generator, device=dev) \
            / math.sqrt(fan_in)
    return {"w1": w(obs_dim, hidden), "w2": w(hidden, hidden), "w3": w(hidden, act_out)}


def policy_apply(params, obs):
    h = torch.tanh(obs @ params["w1"])
    h = torch.tanh(h @ params["w2"])
    return h @ params["w3"]


def make_rollout_fn(env_name: str, n_steps: int, *,
                    device="cuda") -> Tuple[Callable[[int], Tuple[torch.Tensor, torch.Tensor]],
                                            EnvSpec]:
    """Returns (rollout, spec). rollout(seed) -> (obs_traj (n_steps, obs_dim),
    rewards (n_steps,)) on the device: the policy's weights and the initial
    state drawn from a generator seeded with `seed` (`rollout.init(seed)` ->
    (params, state0)), then the n_steps loop (`rollout.core(params,
    state0)`, which also takes weights and a state from elsewhere).
    Discrete actions are the logits' argmax (the first of equal maxima, as
    `jnp.argmax`), continuous ones their tanh."""
    dev = resolve_device(device)
    spec, init_fn, step_fn = make_env(env_name, device=dev)
    act_out = spec.n_actions if spec.n_actions else spec.act_dim

    @torch.no_grad()
    def core(params, state0):
        obs = torch.zeros((spec.obs_dim,), dtype=F32, device=dev)
        state = state0
        obs_traj = torch.empty((n_steps, spec.obs_dim), dtype=F32, device=dev)
        rewards = torch.empty((n_steps,), dtype=F32, device=dev)
        for t in range(n_steps):
            logits = policy_apply(params, obs)
            action = torch.argmax(logits) if spec.n_actions else torch.tanh(logits)
            state, obs, reward, _ = step_fn(state, action)
            obs_traj[t] = obs
            rewards[t] = reward
        return obs_traj, rewards

    def init(seed: int):
        gen = torch.Generator(device=dev).manual_seed(seed)
        params = init_policy(gen, spec.obs_dim, act_out, device=dev)
        return params, init_fn(gen)

    def rollout(seed: int):
        return core(*init(seed))

    rollout.core, rollout.init = core, init
    return rollout, spec


def rollout_task(env_name: str, n_steps: int, seed: int, *, device="cuda") -> Dict:
    """The Syndeo task: collect n_steps interactions, return the artifact
    (observation trajectory -- its SIZE is what stresses the object store,
    exactly the paper's Humanoid effect). The trajectory and the reward sum
    cross to the host in one copy."""
    fn, spec = make_rollout_fn(env_name, n_steps, device=device)
    t0 = time.perf_counter()
    obs_traj, rewards = fn(seed)
    host = torch.cat([obs_traj.flatten(), rewards.sum()[None]]).cpu().numpy()
    return {
        "env": env_name,
        "interactions": int(n_steps),
        "wall_s": time.perf_counter() - t0,
        "obs": host[:-1].reshape(n_steps, spec.obs_dim),   # (n_steps, obs_dim) artifact
        "reward_sum": float(host[-1]),
    }


def run_benchmark_local(cluster, env_name: str, n_workers: int,
                        steps_per_worker: int = 1000, *,
                        device="cuda") -> Tuple[float, Dict]:
    """Real (threaded) run on a cluster with SyndeoCluster's `submit(fn,
    *args, group=..., **kwargs)` and `wait_all(tasks, timeout)`: returns
    (throughput, stats)."""
    t0 = time.perf_counter()
    tasks = [cluster.submit(rollout_task, env_name, steps_per_worker, i,
                            device=device, group=f"rollout-{env_name}")
             for i in range(n_workers)]
    results = cluster.wait_all(tasks, timeout=600.0)
    wall = time.perf_counter() - t0
    total = sum(r["interactions"] for r in results)
    return total / wall, {"wall_s": wall, "n_tasks": len(results)}

"""Environments of the paper's RL rollout benchmark as tensor functions, the
port of the JAX package's `rl/envs.py`.

Classic control (CartPole, Pendulum, Acrobot) follows the Gymnasium
dynamics, in the reference's order of operations. The MuJoCo entries are
surrogates, as in the reference: the right observation and action sizes and
a dense, contact-solver-shaped step (three tanh iterations of an internal
state through a fixed random matrix), because the paper's systems claims
(throughput against worker count) depend on the per-step cost and the
artifact's size, not on articulated-body dynamics. `EnvSpec.step_cost_s`
is the per-step cost on one Xeon E5-2683 core from the paper's 28-CPU
throughput (Table III), which the reference's paper-scale simulation reads.

A step reads nothing back to the host: it is a few elementwise ops (and,
for a surrogate, small matrix products) on the state's device. `done` is
computed and returned, and the rollout does not act on it, as in the
reference.
"""
from __future__ import annotations

import math
import zlib
from dataclasses import dataclass
from typing import Callable, Dict, Optional, Tuple

import torch

from repro_torch.device import resolve_device

F32 = torch.float32


@dataclass(frozen=True)
class EnvSpec:
    name: str
    obs_dim: int
    act_dim: int                  # continuous dims (0 => discrete n_actions)
    n_actions: int = 0
    # per-interaction compute cost on one Xeon E5-2683 core, seconds,
    # derived from Table III: t = 28 / throughput_mean(28 cpus)
    step_cost_s: float = 0.005
    surrogate_dim: int = 0        # internal state size for mujoco surrogates


# paper Table III 28-CPU mean throughputs -> per-step costs
_PAPER_28CPU = {
    "Acrobot": 5656, "Ant": 5106, "Cartpole": 6876, "HalfCheetah": 6343,
    "Hopper": 5505, "Humanoid": 4108, "HumanoidStandup": 3573,
    "InvertedDoublePendulum": 6265, "InvertedPendulum": 5864,
    "Pendulum": 5895, "Pusher": 5939, "Reacher": 6521, "Swimmer": 6168,
    "Walker2d": 5264,
}


def _cost(name: str) -> float:
    return 28.0 / _PAPER_28CPU[name]


ENV_SPECS: Dict[str, EnvSpec] = {
    "Acrobot": EnvSpec("Acrobot", 6, 0, n_actions=3, step_cost_s=_cost("Acrobot")),
    "Cartpole": EnvSpec("Cartpole", 4, 0, n_actions=2, step_cost_s=_cost("Cartpole")),
    "Pendulum": EnvSpec("Pendulum", 3, 1, step_cost_s=_cost("Pendulum")),
    "Ant": EnvSpec("Ant", 27, 8, step_cost_s=_cost("Ant"), surrogate_dim=128),
    "HalfCheetah": EnvSpec("HalfCheetah", 17, 6, step_cost_s=_cost("HalfCheetah"), surrogate_dim=96),
    "Hopper": EnvSpec("Hopper", 11, 3, step_cost_s=_cost("Hopper"), surrogate_dim=64),
    "Humanoid": EnvSpec("Humanoid", 376, 17, step_cost_s=_cost("Humanoid"), surrogate_dim=256),
    "HumanoidStandup": EnvSpec("HumanoidStandup", 376, 17, step_cost_s=_cost("HumanoidStandup"), surrogate_dim=256),
    "InvertedDoublePendulum": EnvSpec("InvertedDoublePendulum", 11, 1, step_cost_s=_cost("InvertedDoublePendulum"), surrogate_dim=32),
    "InvertedPendulum": EnvSpec("InvertedPendulum", 4, 1, step_cost_s=_cost("InvertedPendulum"), surrogate_dim=16),
    "Pusher": EnvSpec("Pusher", 23, 7, step_cost_s=_cost("Pusher"), surrogate_dim=96),
    "Reacher": EnvSpec("Reacher", 11, 2, step_cost_s=_cost("Reacher"), surrogate_dim=32),
    "Swimmer": EnvSpec("Swimmer", 8, 2, step_cost_s=_cost("Swimmer"), surrogate_dim=48),
    "Walker2d": EnvSpec("Walker2d", 17, 6, step_cost_s=_cost("Walker2d"), surrogate_dim=96),
}

StepFn = Callable[[torch.Tensor, torch.Tensor],
                  Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]]


# ----------------------------------------------------------------------------
# Exact classic-control dynamics
# ----------------------------------------------------------------------------

def cartpole_step(state, action):
    """Gymnasium CartPole-v1 dynamics. state (4,), action in {0,1} (an
    integer tensor). Returns (state, obs, reward, done)."""
    g, mc, mp, lp, fmag, tau = 9.8, 1.0, 0.1, 0.5, 10.0, 0.02
    x, xd, th, thd = state.unbind(-1)
    force = torch.where(action == 1, fmag, -fmag).to(state.dtype)
    ct, st = torch.cos(th), torch.sin(th)
    tmp = (force + mp * lp * thd ** 2 * st) / (mc + mp)
    thacc = (g * st - ct * tmp) / (lp * (4.0 / 3.0 - mp * ct ** 2 / (mc + mp)))
    xacc = tmp - mp * lp * thacc * ct / (mc + mp)
    new = torch.stack([x + tau * xd, xd + tau * xacc,
                       th + tau * thd, thd + tau * thacc], dim=-1)
    done = (new[..., 0].abs() > 2.4) | (new[..., 2].abs() > 12 * math.pi / 180)
    reward = torch.ones_like(x)
    return new, new, reward, done


def pendulum_step(state, action):
    """Pendulum-v1. state: (th, thd) internal; obs (cos, sin, thd); action
    (1,). The cost's angle is wrapped by a floor modulo (`jnp.mod`), so
    `torch.remainder`, not `fmod`."""
    g, m, l, dt = 10.0, 1.0, 1.0, 0.05
    th, thd = state[..., 0], state[..., 1]
    u = torch.clamp(action[..., 0], -2.0, 2.0)
    cost = (torch.remainder(th + math.pi, 2 * math.pi) - math.pi) ** 2 \
        + 0.1 * thd ** 2 + 0.001 * u ** 2
    thd_new = thd + (3 * g / (2 * l) * torch.sin(th) + 3.0 / (m * l ** 2) * u) * dt
    thd_new = torch.clamp(thd_new, -8.0, 8.0)
    th_new = th + thd_new * dt
    new = torch.stack([th_new, thd_new], dim=-1)
    obs = torch.stack([torch.cos(th_new), torch.sin(th_new), thd_new], dim=-1)
    return new, obs, -cost, torch.zeros_like(th, dtype=torch.bool)


def acrobot_step(state, action):
    """Acrobot-v1 (Euler integration variant). state (4,), action in
    {0,1,2} (an integer tensor)."""
    m1 = m2 = 1.0
    l1 = 1.0
    lc1 = lc2 = 0.5
    I1 = I2 = 1.0
    g, dt = 9.8, 0.2
    th1, th2, d1v, d2v = state.unbind(-1)
    torque = action.to(F32) - 1.0
    d1 = m1 * lc1 ** 2 + m2 * (l1 ** 2 + lc2 ** 2 + 2 * l1 * lc2 * torch.cos(th2)) + I1 + I2
    d2 = m2 * (lc2 ** 2 + l1 * lc2 * torch.cos(th2)) + I2
    phi2 = m2 * lc2 * g * torch.cos(th1 + th2 - math.pi / 2)
    phi1 = (-m2 * l1 * lc2 * d2v ** 2 * torch.sin(th2)
            - 2 * m2 * l1 * lc2 * d2v * d1v * torch.sin(th2)
            + (m1 * lc1 + m2 * l1) * g * torch.cos(th1 - math.pi / 2) + phi2)
    ddth2 = (torque + d2 / d1 * phi1 - m2 * l1 * lc2 * d1v ** 2 * torch.sin(th2)
             - phi2) / (m2 * lc2 ** 2 + I2 - d2 ** 2 / d1)
    ddth1 = -(d2 * ddth2 + phi1) / d1
    new = torch.stack([th1 + dt * d1v, th2 + dt * d2v,
                       torch.clamp(d1v + dt * ddth1, -4 * math.pi, 4 * math.pi),
                       torch.clamp(d2v + dt * ddth2, -9 * math.pi, 9 * math.pi)], dim=-1)
    n0, n1 = new[..., 0], new[..., 1]
    obs = torch.stack([torch.cos(n0), torch.sin(n0), torch.cos(n1), torch.sin(n1),
                       new[..., 2], new[..., 3]], dim=-1)
    done = -torch.cos(n0) - torch.cos(n1 + n0) > 1.0
    reward = torch.full_like(th1, -1.0)
    return new, obs, reward, done


# ----------------------------------------------------------------------------
# MuJoCo surrogates
# ----------------------------------------------------------------------------

def surrogate_seed(name: str) -> int:
    """The seed of a surrogate's matrices: a stable function of its name (the
    reference seeds with `hash(name)`, which Python salts per process)."""
    return zlib.crc32(name.encode()) % (2 ** 31)


def orthogonal(z: torch.Tensor) -> torch.Tensor:
    """The orthogonal matrix of a square normal draw z, as
    `jax.random.orthogonal` makes it: Q of z's QR, its columns signed by R's
    diagonal."""
    q, r = torch.linalg.qr(z)
    return q * torch.sign(torch.diagonal(r))[None, :]


def surrogate_matrices(spec: EnvSpec, generator: Optional[torch.Generator] = None):
    """(W, Pobs, Pact) of a surrogate, drawn as the reference draws them: W
    orthogonal times 0.99, Pobs (n, obs_dim) and Pact (act_dim, n) normal /
    sqrt(n). From `generator` (on its device), else from a CPU generator
    seeded with `surrogate_seed(spec.name)`, the same on every device."""
    if generator is None:
        generator = torch.Generator().manual_seed(surrogate_seed(spec.name))
    dev, n = generator.device, spec.surrogate_dim
    W = orthogonal(torch.randn((n, n), generator=generator, device=dev)) * 0.99
    Pobs = torch.randn((n, spec.obs_dim), generator=generator, device=dev) / math.sqrt(n)
    Pact = torch.randn((spec.act_dim, n), generator=generator, device=dev) / math.sqrt(n)
    return W, Pobs, Pact


def surrogate_step_fn(spec: EnvSpec, *, generator: Optional[torch.Generator] = None,
                      matrices=None, device="cuda") -> StepFn:
    """MuJoCo surrogate: a contact-solver-shaped dense workload with the
    right obs/act dims. W is a fixed random internal dynamics matrix.
    `matrices`, the tensors (W, Pobs, Pact), replaces the draw (the tests
    hand over the reference's through `bridge.surrogate_matrices_from_numpy`)."""
    dev = resolve_device(device)
    if matrices is None:
        matrices = surrogate_matrices(spec, generator)
    W, Pobs, Pact = (m.to(device=dev, dtype=F32) for m in matrices)

    def step(state, action):
        # a few "solver iterations" of the internal state
        a = action @ Pact
        s = state
        for _ in range(3):
            s = torch.tanh(s @ W + a)
        obs = s @ Pobs
        reward = -torch.mean(torch.square(obs)) + torch.mean(action ** 2) * -0.01
        return s, obs, reward, torch.zeros((), dtype=torch.bool, device=s.device)

    return step


InitFn = Callable[[torch.Generator], torch.Tensor]


def _uniform(shape, lo: float, hi: float, dev) -> InitFn:
    def init(generator):
        return torch.rand(shape, generator=generator, device=dev) * (hi - lo) + lo
    return init


def make_env(name: str, *, device="cuda",
             generator: Optional[torch.Generator] = None) -> Tuple[EnvSpec, InitFn, StepFn]:
    """Returns (spec, init_fn(generator) -> state, step_fn(state, action)).
    init_fn draws the initial state from a generator on `device`;
    `generator` is the surrogate matrices' (see surrogate_matrices)."""
    dev = resolve_device(device)
    spec = ENV_SPECS[name]
    if name == "Cartpole":
        return spec, _uniform((4,), -0.05, 0.05, dev), cartpole_step
    if name == "Pendulum":
        return spec, _uniform((2,), -1.0, 1.0, dev), pendulum_step
    if name == "Acrobot":
        return spec, _uniform((4,), -0.1, 0.1, dev), acrobot_step
    step = surrogate_step_fn(spec, generator=generator, device=dev)

    def init(generator, n=spec.surrogate_dim):
        return torch.randn((n,), generator=generator, device=dev) * 0.1
    return spec, init, step

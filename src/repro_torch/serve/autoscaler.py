"""SLO-driven replica autoscaler for the serving plane, the port of the JAX
package's `core/autoscaler.py::ReplicaAutoscaler` with its config and
event, with the same fields, defaults and decision order.

The reference's deployment model is a *static* gang allocation (a Slurm
job, a Kubernetes Job) hosting a *dynamic* scheduler. Here the allocation
is a serving job's `--mesh DxM` (`launch/serve.py`): its D rows are built
at start, and this autoscaler decides how many of them the router serves
through, growing on the router's p99 latency or mean queue depth and
shrinking through `Router.retire_replica`'s drain, so a retired row
finishes its in-flight decodes.

The reference's worker-pool `Autoscaler` (sizing the runtime's workers on
its scheduler's backlog) belongs to that runtime, which the port does not
carry, and is not copied.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, List, Optional


@dataclass
class ScalingEvent:
    at: float
    action: str          # "scale_up" | "scale_down"
    count: int
    reason: str
    workers_before: int


@dataclass
class ReplicaScalingConfig:
    """SLO targets for the serving-plane replica autoscaler."""
    min_replicas: int = 1
    max_replicas: int = 8
    p99_target_ms: float = 500.0         # grow when p99 exceeds this
    queue_depth_target: float = 4.0      # grow when mean backlog exceeds this
    low_water_fraction: float = 0.4      # shrink when BOTH signals are under
                                         # fraction * target
    scale_up_cooldown_s: float = 1.0
    scale_down_cooldown_s: float = 10.0
    max_step: int = 2                    # replicas added/removed per decision


class ReplicaAutoscaler:
    """SLO-driven replica-set autoscaler for the serving plane.

    It grows when the router's p99 latency or mean queue depth exceeds the
    target, and shrinks -- via the drain plane, so an evicted replica
    finishes its in-flight decodes -- only when BOTH signals sit below the
    low-water fraction of their targets.

    `grow_fn(count) -> int` brings up to `count` replicas into the router
    and returns how many it actually added (`launch/serve.py`: the lowest
    parked rows of the job). `shrink_fn(count) -> int` retires up to
    `count` replicas gracefully (through `Router.retire_replica`) and
    returns how many it actually removed. Both may under-deliver; the
    autoscaler only trusts the returned counts. The clock is the router's
    unless `clock` is given."""

    def __init__(self, router, grow_fn: Callable[[int], int],
                 shrink_fn: Callable[[int], int],
                 config: Optional[ReplicaScalingConfig] = None,
                 clock: Callable[[], float] = None):
        self.router = router
        self.grow_fn = grow_fn
        self.shrink_fn = shrink_fn
        self.cfg = config or ReplicaScalingConfig()
        self.clock = clock or router.clock
        self._last_up = -math.inf
        self._last_down = -math.inf
        self.events: List[ScalingEvent] = []

    def _emit(self, now: float, action: str, count: int, reason: str,
              before: int) -> ScalingEvent:
        ev = ScalingEvent(now, action, count, reason, before)
        self.events.append(ev)
        return ev

    def tick(self, now: Optional[float] = None) -> Optional[ScalingEvent]:
        now = self.clock() if now is None else now
        n = len(self.router.replicas)
        p99 = self.router.p99_ms()
        depth = self.router.queue_depth()
        cfg = self.cfg

        over_p99 = p99 > cfg.p99_target_ms
        over_depth = depth > cfg.queue_depth_target
        if (over_p99 or over_depth) and n < cfg.max_replicas \
                and now - self._last_up >= cfg.scale_up_cooldown_s:
            want = min(cfg.max_step, cfg.max_replicas - n)
            got = self.grow_fn(want)
            if got > 0:
                self._last_up = now
                sig = (f"p99 {p99:.0f}ms > {cfg.p99_target_ms:.0f}ms"
                       if over_p99 else
                       f"queue depth {depth:.1f} > "
                       f"{cfg.queue_depth_target:.1f}")
                return self._emit(now, "scale_up", got, sig, n)
            return None

        under = (p99 <= cfg.p99_target_ms * cfg.low_water_fraction
                 and depth <= cfg.queue_depth_target * cfg.low_water_fraction)
        if under and n > cfg.min_replicas \
                and now - self._last_down >= cfg.scale_down_cooldown_s:
            want = min(cfg.max_step, n - cfg.min_replicas)
            got = self.shrink_fn(want)
            if got > 0:
                self._last_down = now
                return self._emit(
                    now, "scale_down", got,
                    f"p99 {p99:.0f}ms and depth {depth:.1f} under "
                    f"{cfg.low_water_fraction:.0%} of target", n)
        return None

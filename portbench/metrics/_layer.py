"""What the per-layer readers share. `suffix` is the metric's split by the
end-to-end metric it moves: a `.rollout` metric reads fleet cells only."""
from __future__ import annotations

from typing import Optional

from portbench import flops

KINDS = {"rollout": "fleet"}


def mine(ctx, suffix: str) -> bool:
    return ctx.kind == KINDS[suffix]


def per_step(ctx, suffix: str, key: str, scale: float = 1.0) -> Optional[float]:
    """A window counter or range's seconds per tick or step."""
    if not mine(ctx, suffix) or key not in ctx.per_step:
        return None
    return ctx.per_step[key] * scale


def b1_roofline(ctx, suffix: str) -> Optional[float]:
    """Percent: the B1 launches' summed bound over their summed device time
    in the profiled stretch (None where the trace's launches do not match
    the wrapper's count)."""
    t = ctx.traced
    if not mine(ctx, suffix) or t.b1_device_s is None:
        return None
    return 100.0 * t.b1_bound_s / t.b1_device_s


def device_idle(ctx, suffix: str) -> Optional[float]:
    """Percent of the profiled stretch in which no operation ran on the card."""
    if not mine(ctx, suffix):
        return None
    return 100.0 * (1.0 - ctx.traced.busy_s / ctx.traced.window_s)


def launches(ctx, suffix: str) -> Optional[float]:
    """Kernels a tick or step in the profiled stretch."""
    if not mine(ctx, suffix) or not ctx.traced.kernels:
        return None
    return ctx.traced.kernels / ctx.traced.steps


def mfu(ctx, suffix: str) -> Optional[float]:
    """Percent of the f32 peak: the work of a tick or step over the window's
    wall time per tick or step."""
    if not mine(ctx, suffix):
        return None
    seconds = ctx.window.seconds / ctx.window.steps
    return 100.0 * ctx.flops_per_step() / seconds / flops.PEAK_F32_FLOPS

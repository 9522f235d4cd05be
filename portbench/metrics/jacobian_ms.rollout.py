"""Host milliseconds a tick inside the `jacobian` ranges, over the window."""
from portbench.metrics._layer import per_step


def read(ctx):
    return per_step(ctx, "rollout", "jacobian_s", 1e3)

"""Host milliseconds a tick inside the `network` ranges, over the window."""
from portbench.metrics._layer import per_step


def read(ctx):
    return per_step(ctx, "rollout", "network_s", 1e3)

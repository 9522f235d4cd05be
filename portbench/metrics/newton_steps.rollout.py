"""Newton steps a tick, from the policy's counter over the window."""
from portbench.metrics._layer import per_step


def read(ctx):
    return per_step(ctx, "rollout", "newton_steps")

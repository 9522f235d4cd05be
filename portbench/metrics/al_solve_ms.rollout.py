"""Host milliseconds a tick inside the `al_solve` ranges, over the window."""
from portbench.metrics._layer import per_step


def read(ctx):
    return per_step(ctx, "rollout", "al_solve_s", 1e3)

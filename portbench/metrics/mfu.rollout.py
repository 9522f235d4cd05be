from portbench.metrics._layer import mfu


def read(ctx):
    return mfu(ctx, "rollout")

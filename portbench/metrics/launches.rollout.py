from portbench.metrics._layer import launches


def read(ctx):
    return launches(ctx, "rollout")

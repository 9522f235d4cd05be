from portbench.metrics._layer import device_idle


def read(ctx):
    return device_idle(ctx, "rollout")

from portbench.metrics._layer import b1_roofline


def read(ctx):
    return b1_roofline(ctx, "rollout")

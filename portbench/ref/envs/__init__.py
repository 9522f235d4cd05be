"""The two envs of the benchmark's configurations."""
from .base import Env
from .flying_cartpole import FlyingCartpole
from .quadrotor import RexQuadrotor


def make_env_of(args):
    """The env of a run's args: RexQuadrotor, or FlyingCartpole with its Qscale."""
    name = args["env"].lower()
    if name == "rexquadrotor":
        return RexQuadrotor()
    if name == "flyingcartpole":
        return FlyingCartpole(Qscale=args.get("Qscale", 1.0))
    raise ValueError(f"the reference has no env {args['env']!r}")

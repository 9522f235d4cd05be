"""Environments: batched torch dynamics with `torch.func` Jacobians."""
from .base import Env
from .cartpole import Cartpole2linkEnv, CartpoleEnv
from .flying_cartpole import FlyingCartpole
from .pendulum import PendulumEnv
from .quadrotor import RexQuadrotor

__all__ = ["Env", "CartpoleEnv", "Cartpole2linkEnv", "FlyingCartpole", "PendulumEnv",
           "RexQuadrotor", "make_env", "make_env_of"]


def make_env(name: str, **kwargs):
    """Factory for the envs the port has (names as in
    `deqmpc_tpu/envs/__init__.py:make_env`)."""
    name = name.lower()
    if name == "pendulum":
        return PendulumEnv(stabilization=False)
    if name == "pendulum_stabilize":
        return PendulumEnv(stabilization=True)
    if name in ("cartpole1link", "cartpole-v0"):
        return CartpoleEnv(nx=4, dt=0.05)
    if name == "cartpole2link":
        return CartpoleEnv(nx=6, dt=0.03)
    if name == "rexquadrotor":
        return RexQuadrotor(**kwargs)
    if name == "flyingcartpole":
        return FlyingCartpole(**kwargs)
    if name == "flyingcartpole_obstacles":
        return FlyingCartpole(obstacles=True, **kwargs)
    if name == "flyingcartpole_obstacles_dense":
        # 160 spheres of radius 0.4: a field a straight crossing hits often
        kwargs.setdefault("n_obstacles", 160)
        kwargs.setdefault("obstacle_radius", 0.4)
        return FlyingCartpole(obstacles=True, **kwargs)
    raise ValueError(f"env not ported yet: {name}")


def make_env_of(args):
    """The env of a run's args (a dict): `Qscale` reaches the FlyingCartpole
    names only, as the JAX train CLI passes it (`training/train.py:520`);
    args without it (older checkpoints) take 1."""
    kw = {"Qscale": args.get("Qscale", 1.0)} if "FlyingCartpole" in args["env"] else {}
    return make_env(args["env"], **kw)

"""Environments: batched torch dynamics with `torch.func` Jacobians."""
from .base import Env
from .pendulum import PendulumEnv
from .quadrotor import RexQuadrotor

__all__ = ["Env", "PendulumEnv", "RexQuadrotor", "make_env"]


def make_env(name: str, **kwargs):
    """Factory for the envs this slice ports (names as in
    `deqmpc_tpu/envs/__init__.py:make_env`)."""
    name = name.lower()
    if name == "pendulum":
        return PendulumEnv(stabilization=False)
    if name == "pendulum_stabilize":
        return PendulumEnv(stabilization=True)
    if name == "rexquadrotor":
        return RexQuadrotor(**kwargs)
    raise ValueError(f"env not ported yet: {name}")

"""Solvers: the AL trajectory optimizer and the Anderson fixed-point solver."""
from .al_mpc import ALMPC
from .fp import anderson
from .newton_al import NewtonAL
from .types import ALState, NewtonALConfig, QuadCost

__all__ = ["ALMPC", "ALState", "NewtonAL", "NewtonALConfig", "QuadCost", "anderson"]

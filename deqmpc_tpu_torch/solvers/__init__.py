"""Solvers: the AL trajectory optimizer and the Anderson fixed-point solver."""
from .al_core import ObstacleSet
from .al_mpc import ALMPC
from .fp import anderson
from .newton_al import NewtonAL
from .types import ALState, LinDx, NewtonALConfig, QuadCost

__all__ = ["ALMPC", "ALState", "LinDx", "NewtonAL", "NewtonALConfig", "ObstacleSet", "QuadCost",
           "anderson"]

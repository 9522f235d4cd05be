"""Solvers: the AL trajectory optimizer, the Anderson fixed-point solver and
the interior-point QP solver with its SQP MPC."""
from .al_core import ObstacleSet
from .al_mpc import ALMPC
from .fp import anderson
from .ip_mpc import IPMPC
from .newton_al import NewtonAL
from .pdipm import KKTFactors, QPSolution, qp_layer, qp_solve, qp_solve_single
from .types import ALState, LinDx, NewtonALConfig, QuadCost

__all__ = ["ALMPC", "ALState", "IPMPC", "KKTFactors", "LinDx", "NewtonAL", "NewtonALConfig",
           "ObstacleSet", "QPSolution", "QuadCost", "anderson", "qp_layer", "qp_solve",
           "qp_solve_single"]

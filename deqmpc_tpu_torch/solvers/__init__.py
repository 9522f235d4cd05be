"""Solvers: the AL trajectory optimizer, the fixed-point solvers (Anderson,
its cost-aware flavour, good Broyden) and the interior-point QP solver with
its SQP MPC."""
from .al_core import ObstacleSet
from .al_mpc import ALMPC
from .fp import anderson, anderson_jiio, broyden
from .ip_mpc import IPMPC
from .newton_al import NewtonAL
from .pdipm import KKTFactors, QPSolution, qp_layer, qp_solve, qp_solve_single
from .types import ALState, LinDx, NewtonALConfig, QuadCost

__all__ = ["ALMPC", "ALState", "IPMPC", "KKTFactors", "LinDx", "NewtonAL", "NewtonALConfig",
           "ObstacleSet", "QPSolution", "QuadCost", "anderson", "anderson_jiio", "broyden",
           "qp_layer", "qp_solve", "qp_solve_single"]

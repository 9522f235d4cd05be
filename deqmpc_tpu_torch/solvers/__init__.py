"""Solvers: the AL trajectory optimizer, the fixed-point solvers (Anderson,
its cost-aware flavour, good Broyden) and the interior-point QP solver with
its SQP MPC, and the rollout, cost and gradient-check utilities."""
from .al_core import ObstacleSet
from .al_mpc import ALMPC
from .fp import anderson, anderson_jiio, broyden
from .ip_mpc import IPMPC
from .newton_al import NewtonAL
from .pdipm import KKTFactors, QPSolution, qp_layer, qp_solve, qp_solve_single
from .types import ALState, LinDx, NewtonALConfig, QuadCost
from .util import check_fd_grads, get_cost, get_traj

__all__ = ["ALMPC", "ALState", "IPMPC", "KKTFactors", "LinDx", "NewtonAL", "NewtonALConfig",
           "ObstacleSet", "QPSolution", "QuadCost", "anderson", "anderson_jiio", "broyden",
           "check_fd_grads", "get_cost", "get_traj", "qp_layer", "qp_solve", "qp_solve_single"]

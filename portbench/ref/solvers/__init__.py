from .al_mpc import ALMPC
from .newton_al import NewtonAL
from .types import ALState, NewtonALConfig, QuadCost

from .deqmpc_policy import DEQMPCPolicy, PolicyConfig, build_policy
from .tracking_mpc import TrackingMPC

"""Policies: the tracking-MPC adapter, the DEQ-MPC policy and its loss."""
from .deqmpc_policy import DEQMPCPolicy, PolicyConfig, build_policy
from .losses import compute_loss_deqmpc
from .tracking_mpc import TrackingMPC

__all__ = ["DEQMPCPolicy", "PolicyConfig", "TrackingMPC", "build_policy",
           "compute_loss_deqmpc"]

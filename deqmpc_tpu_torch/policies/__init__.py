"""Policies: the tracking-MPC adapter and the DEQ-MPC policy."""
from .deqmpc_policy import DEQMPCPolicy, PolicyConfig, build_policy
from .tracking_mpc import TrackingMPC

__all__ = ["DEQMPCPolicy", "PolicyConfig", "TrackingMPC", "build_policy"]

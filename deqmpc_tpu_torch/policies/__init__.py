"""Policies: the tracking-MPC adapter, the DEQ-MPC policy and its feed-forward
variant, the plain behaviour-cloning policy, and the loss."""
from .deqmpc_policy import DEQMPCPolicy, NNMPCPolicy, PolicyCarry, PolicyConfig, build_policy
from .losses import compute_loss_deqmpc
from .nn_policy import NNPolicy
from .tracking_mpc import TrackingMPC

__all__ = ["DEQMPCPolicy", "NNMPCPolicy", "NNPolicy", "PolicyCarry", "PolicyConfig",
           "TrackingMPC", "build_policy", "compute_loss_deqmpc"]

"""Policies: the tracking-MPC adapter, the DEQ-MPC policy, its feed-forward
variant and the policy variants, the plain behaviour-cloning policy, and
the losses."""
from .deqmpc_policy import (DEQMPCPolicy, NNMPCPolicy, PolicyCarry, PolicyConfig, build_policy,
                            f32_observation)
from .losses import compute_loss_deqmpc, compute_loss_deqmpc_hist
from .nn_policy import NNPolicy
from .policy_variants import (DEQMPCPolicyDelta, DEQMPCPolicyFeedback, DEQMPCPolicyHistory,
                              DEQMPCPolicyHistoryEstPred, DEQMPCPolicyMem, DEQMPCPolicyQ)
from .tracking_mpc import TrackingMPC

__all__ = ["DEQMPCPolicy", "DEQMPCPolicyDelta", "DEQMPCPolicyFeedback", "DEQMPCPolicyHistory",
           "DEQMPCPolicyHistoryEstPred", "DEQMPCPolicyMem", "DEQMPCPolicyQ", "NNMPCPolicy",
           "NNPolicy", "PolicyCarry", "PolicyConfig", "TrackingMPC", "build_policy", "f32_observation",
           "compute_loss_deqmpc", "compute_loss_deqmpc_hist"]

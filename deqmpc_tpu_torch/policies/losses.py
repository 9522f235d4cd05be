"""Per-iteration imitation losses for DEQ-MPC training.

Port of `loss_type_conditioned`, `compute_cost_coeff`,
`compute_loss_deqmpc`, `_iter_weights`, `compute_loss_deqmpc_hist` and
`compute_decomposed_losses` (`deqmpc_tpu/policies/losses.py:25-219`): every round's (optimizer
trajectory, network trajectory) pair is held against the expert window,
loss = sum_j mean_b(loss_opt_j + deq_reg * loss_nn_j), plus, for the Q
variant, 0.02 * sum_t |q_scaling_j| per sample (`losses.py:102-117`). The
residual iteration and example weights are computed for logging and, as
in the JAX package, not applied. The History/EstPred loss logs each
round's state-estimate losses against the observed history and, as in
JAX, leaves them out of the total.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch


def loss_type_conditioned(pred, targ, mask, loss_type: str) -> Tuple[torch.Tensor, torch.Tensor]:
    """(per-sample loss (bsz,), per-sample masked L1 residual (bsz,))."""
    diff = (pred - targ) * mask[:, :, None]
    res = diff.abs().sum(dim=-1).mean(dim=1)
    if loss_type == "l2":
        val = torch.square(torch.linalg.vector_norm(diff, dim=-1)).mean(dim=1)
    elif loss_type == "l1":
        val = diff.abs().sum(dim=-1).mean(dim=1)
    elif loss_type == "hinge":
        val = torch.minimum(diff.abs(), torch.square(diff)).sum(dim=-1).mean(dim=1)
    else:
        raise ValueError(loss_type)
    return val, res


def compute_cost_coeff(nq: int, T: int, out_type: int, loss_type: str,
                       gt_states, gt_actions, gt_mask, nominal_states, nominal_actions,
                       coeff_pos, coeff_vel, coeff_act):
    """Per-sample supervision cost in position / velocity / action streams,
    each with its coefficient."""
    loss, res = 0.0, 0.0
    if out_type in (0, 2):
        lk, rk = loss_type_conditioned(nominal_actions[:, : T - 1], gt_actions[:, : T - 1],
                                       gt_mask[:, : T - 1], loss_type)
        loss = loss + lk * coeff_act
        res = res + rk
    if out_type in (1, 2):
        li, ri = loss_type_conditioned(nominal_states[..., :nq], gt_states[..., :nq],
                                       gt_mask, loss_type)
        lj, rj = loss_type_conditioned(nominal_states[..., nq:], gt_states[..., nq:],
                                       gt_mask, loss_type)
        loss = loss + li * coeff_pos + lj * coeff_vel
        res = res + ri + rj
    if out_type == 3:
        li, ri = loss_type_conditioned(nominal_states[..., :nq], gt_states[..., :nq],
                                       gt_mask, loss_type)
        loss = loss + li * coeff_pos
        res = res + ri
    return loss, res


def compute_loss_deqmpc(policy, gt_states, gt_actions, gt_mask, policy_out,
                        coeffs: Optional[torch.Tensor] = None,
                        x_init: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
    """The DEQ-MPC loss. `policy` provides nq, T, out_type, loss_type and
    deq_reg; policy_out["trajs"] lists (net_states, opt_states, actions)
    per round; x_init (the cold start's initial trajectory) adds a
    residual column before the rounds'."""
    trajs = policy_out["trajs"]
    n_iter = len(trajs)
    nq, T = policy.nq, policy.T
    cs = torch.ones((n_iter, 3), dtype=gt_states.dtype, device=gt_states.device)
    if coeffs is not None:
        cs[:, : coeffs.shape[1]] = coeffs

    def cost(states, actions, j):
        return compute_cost_coeff(nq, T, policy.out_type, policy.loss_type, gt_states,
                                  gt_actions, gt_mask, states, actions,
                                  cs[j, 0], cs[j, 1], cs[j, 2])

    losses, loss_opts, loss_nns, residuals, q_losses = [], [], [], [], []
    q_pen = policy_out.get("q_scaling")
    if x_init is not None:
        residuals.append(cost(x_init, trajs[0][2] * 0, 0)[1])
    for j, (net_states, opt_states, actions) in enumerate(trajs):
        loss_opt_j, res = cost(opt_states, actions, j)
        loss_nn_j, _ = cost(net_states, actions, j)
        total_j = loss_opt_j + policy.deq_reg * loss_nn_j
        if q_pen is not None:
            # the pull of the scalings towards 0 (Q * (q + 1) towards Q)
            lq = 0.02 * q_pen[j].abs().sum(dim=1)
            total_j = total_j + lq
            q_losses.append(lq.mean())
        losses.append(total_j)
        loss_opts.append(loss_opt_j.mean())
        loss_nns.append(loss_nn_j.mean())
        residuals.append(res)
    losses = torch.stack(losses, dim=1)            # (bsz, n_iter)
    residuals = torch.stack(residuals, dim=1)      # (bsz, n_iter[+1])
    # computed for logging, not applied (as in the JAX package)
    ex_weights = residuals.mean(dim=1, keepdim=True)
    ex_weights = ex_weights / (ex_weights.mean() + 1e-12)
    loss_end, _ = cost(trajs[-1][1], trajs[-1][2], n_iter - 1)
    extra = {"losses_iter_q": torch.stack(q_losses)} if q_losses else {}
    return {
        **extra,
        "loss": losses.mean(dim=0).sum(),
        "loss_end": loss_end.mean(),
        "losses_iter_opt": torch.stack(loss_opts),
        "losses_iter_nn": torch.stack(loss_nns),
        "losses_iter": losses.mean(dim=0),
        "residuals": residuals[:, -1],
        "ex_weights": ex_weights,
        "iter_weights": _iter_weights(residuals, gt_mask),
    }


def _iter_weights(residuals, gt_mask):
    """Residual-ratio iteration weights 5**log(res_0 / (10 res_j)),
    normalised per sample, uniform for one-step windows. A diagnostic:
    never multiplied into the loss."""
    w = 5.0 ** torch.log(residuals[:, :1] / (10.0 * residuals[:, :-1] + 1e-12))
    one_step = (gt_mask.sum(dim=1) == 1)[:, None]
    w = torch.where(one_step, torch.ones_like(w), w)
    return w / (w.sum(dim=1, keepdim=True) + 1e-12)


def compute_loss_deqmpc_hist(policy, gt_states, gt_actions, gt_obs, gt_mask, policy_out,
                             coeffs: Optional[torch.Tensor] = None,
                             x_init: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
    """The History/EstPred loss (`losses.py:164-199`): `compute_loss_deqmpc`
    and, where the forward gave `nominal_x_ests`, each round's estimate
    losses against the observed history gt_obs (bsz, H, nx), before and
    after the estimator (`losses_x_ests`, `losses_x_ests_post`), logged
    and left out of the loss."""
    out = compute_loss_deqmpc(policy, gt_states, gt_actions, gt_mask, policy_out,
                              coeffs=coeffs, x_init=x_init)
    x_ests = policy_out.get("nominal_x_ests")
    if x_ests is None:
        return out
    H = gt_obs.shape[1]
    ones = torch.ones(gt_mask.shape[:1] + (H,), dtype=gt_mask.dtype, device=gt_mask.device)
    u0 = torch.zeros(gt_obs.shape[:2] + (policy.nu,), dtype=gt_obs.dtype, device=gt_obs.device)

    def cost(x_est):
        return compute_cost_coeff(policy.nq, H, policy.out_type, policy.loss_type, gt_obs, u0,
                                  ones, x_est, u0, 1.0, 1.0, 1.0)[0].mean()

    out["losses_x_ests"] = torch.stack([cost(pre) for pre, _ in x_ests])
    out["losses_x_ests_post"] = torch.stack([cost(post) for _, post in x_ests])
    return out


def compute_decomposed_losses(policy, gt_states, gt_actions, gt_mask,
                              policy_out) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """Per round, its batch-mean (opt, nn) losses with unit coefficients
    (`losses.py:201-219`, which stacks them into two (n_iter,) arrays): what
    the gradient-ratio coefficients probe (`training/grad_coeffs.py`). Kept
    as separate scalars, so that a gradient of one round's loss walks only
    the rounds it depends on."""
    def cost(states, actions):
        return compute_cost_coeff(policy.nq, policy.T, policy.out_type, policy.loss_type,
                                  gt_states, gt_actions, gt_mask, states, actions,
                                  1.0, 1.0, 1.0)[0].mean()

    return [(cost(opt, actions), cost(net, actions))
            for net, opt, actions in policy_out["trajs"]]

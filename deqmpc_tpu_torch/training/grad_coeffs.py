"""Gradient-ratio loss coefficients (`--grad_coeff`).

Port of `_out_head_path`, `compute_grad_ratio_coeffs` and
`update_coeffs_ema` (`deqmpc_tpu/training/grad_coeffs.py:25-100`): each
round's loss (opt + deq_reg * nn) gives its own gradient at the network's
output head; the coefficients rescale each round's loss so that its head
gradient matches the first round's with signal, smoothed by an EMA. JAX
takes the rounds' gradients in one `jacrev`; here each is one
`torch.autograd.grad` over the retained graph of round j's own loss, which
runs the implicit backwards of rounds 0..j (the block-tridiagonal kernel):
N(N+1)/2 of them for N rounds.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from ..policies.losses import compute_decomposed_losses


def out_head(model: nn.Module, key: str = "out") -> Optional[nn.Module]:
    """The output head, the probe surface: the submodule named `key`,
    searched depth first (a direct child first, as JAX searches its
    parameter dicts); None if there is none."""
    children = dict(model.named_children())
    if key in children:
        return children[key]
    for child in children.values():
        found = out_head(child, key)
        if found is not None:
            return found
    return None


def compute_grad_ratio_coeffs(policy, batch, qp_solve: bool = True,
                              eps: float = 1e-8) -> Tuple[torch.Tensor, ...]:
    """(ratios (deq_iter,), losses_opt, losses_nn) on `batch` (device
    tensors): ratios[j] = |g_ref| / max(|g_j|, eps), g_j the head gradient
    of round j's loss, g_ref the first round's above eps (round 0 if none);
    rounds without signal and ratios above 1e6 get 1. The forward takes
    `qp_solve` and no final solve, as JAX's. KeyError without a head."""
    head = out_head(policy.model)
    if head is None:
        raise KeyError("no output head in the model")
    params = list(head.parameters())
    obs = batch["obs"]
    if not policy.takes_history and obs.dim() == 3:
        obs = obs[:, -1]
    extra = (batch["obs_action"],) if policy.takes_action_history else ()
    policy_out = policy.forward(obs, *extra, qp_solve=qp_solve, lastqp_solve=False)
    T = policy.T
    losses = compute_decomposed_losses(policy, batch["state"][:, :T], batch["action"][:, :T],
                                       batch["mask"][:, :T], policy_out)
    norms = []
    for j, (lo_j, ln_j) in enumerate(losses):
        grads = torch.autograd.grad(lo_j + policy.deq_reg * ln_j, params,
                                    retain_graph=j < len(losses) - 1, allow_unused=True)
        norms.append(torch.sqrt(sum(torch.sum(g * g) for g in grads if g is not None)
                                + torch.zeros((), dtype=lo_j.dtype, device=lo_j.device)))
    grads = torch.stack(norms)
    lo, ln = (torch.stack(x) for x in zip(*losses))
    has_signal = grads > eps
    g_ref = grads[torch.argmax(has_signal.to(torch.int8))]
    ratios = torch.where(has_signal, g_ref / torch.clamp(grads, min=eps),
                         torch.ones_like(grads))
    ratios = torch.where(ratios > 1e6, torch.ones_like(ratios), ratios)
    return ratios.detach(), lo.detach(), ln.detach()


def update_coeffs_ema(coeffs, ratios, gamma: float = 0.9):
    """EMA of the (deq_iter, 3) coefficients, one ratio spread over a
    round's three streams."""
    return gamma * coeffs + (1 - gamma) * ratios[:, None].to(coeffs.dtype)

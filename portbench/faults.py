"""Faults planted in the port, each of which `correct` has to come out false
on: the CPU tests plant them under a whole run, `calibrate.py --faults` reads
them at a cell's own size on the card. Each takes a `pytest.MonkeyPatch`
and patches a class of the port, so it holds for every instance until the
patch is undone.
"""
from __future__ import annotations

import torch


def step_unchanged(mp):
    """The env step returns the state it was given."""
    from deqmpc_tpu_torch.envs.base import Env

    step = Env.step
    mp.setattr(Env, "step", lambda self, x, u: (x, step(self, x, u)[1]))


def _policy_output(mp, change):
    """`change(forward, policy, obs, kw)` in place of the policy's forward."""
    from deqmpc_tpu_torch.policies import deqmpc_policy

    forward = deqmpc_policy.DEQMPCPolicy.forward
    mp.setattr(deqmpc_policy.DEQMPCPolicy, "forward",
               lambda self, obs, **kw: change(forward, self, obs, kw))


def half_lanes(mp):
    """Half of the lanes left out: every output of theirs copied from the
    other half."""
    def change(forward, self, obs, kw):
        n, half = obs.shape[0], obs.shape[0] // 2
        out = forward(self, obs[:half], **kw)
        out["trajs"] = [tuple(torch.cat([t, t[: n - half]]) for t in traj)
                        for traj in out["trajs"]]
        return out
    _policy_output(mp, change)


def half_unsolved(mp):
    """The AL solve leaves the upper half of the lanes where it started: their
    states and actions are the network's reference, unsolved. The proposal is
    untouched."""
    from deqmpc_tpu_torch.solvers import al_mpc

    solve = al_mpc.ALMPC.solve

    def planted(self, x0, cost, state, x_init=None, u_init=None, *a, **kw):
        x, u, status, new_state = solve(self, x0, cost, state, x_init, u_init, *a, **kw)
        h = x.shape[0] // 2
        x = torch.cat([x[:h], x_init[h:].to(x.dtype)])
        u = torch.cat([u[:h], u_init[h:].to(u.dtype)])
        return x, u, status, new_state._replace(x=x.detach(), u=u.detach())
    mp.setattr(al_mpc.ALMPC, "solve", planted)


def action_altered(mp):
    """Every lane's action moved by 5% where the policy produces it."""
    def change(forward, self, obs, kw):
        out = forward(self, obs, **kw)
        x_ref, x, u = out["trajs"][-1]
        out["trajs"][-1] = (x_ref, x, u * 1.05)
        return out
    _policy_output(mp, change)


def action_nonfinite(mp):
    """One lane's action NaN where the policy produces it."""
    def change(forward, self, obs, kw):
        out = forward(self, obs, **kw)
        x_ref, x, u = out["trajs"][-1]
        out["trajs"][-1] = (x_ref, x, torch.cat([torch.full_like(u[:1], float("nan")), u[1:]]))
        return out
    _policy_output(mp, change)


FAULTS = {f.__name__: f for f in (step_unchanged, half_lanes, half_unsolved, action_altered,
                                  action_nonfinite)}

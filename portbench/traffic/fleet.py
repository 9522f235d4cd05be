"""Closed-loop rollouts of a fleet of lanes: the `fleet` traffic kind.

Every lane is one vehicle under the policy. A tick is one cold
`DEQMPCPolicy.forward` on all lanes' states, then `env.step` on the first
action of the last solve, as `training/eval.eval_policy` does. Start states
come from `env.reset(torch.Generator().manual_seed(seed), lanes)`. Episodes
last the mix's `restart_every` ticks at staggered phases, as a rollout
fleet that resets each lane when its episode ends: before each tick t >= 1
the lanes i with i = t (mod restart_every) start again from a reset drawn
from the seed and t. So from tick `restart_every` - 1 on every tick holds the same
mix of episode ages, and a run's work per tick does not turn on how many
ticks the host fits into the window. The warm-up tick of set-up runs on
another seeded batch.

`correct` (see `check`): every tick's input states against the reference's
own (its reset of the seed at tick 0; after that the program's states after
the tick before, with the restarted lanes from the reference's reset), and
every window tick's env step against the reference's step of the same state
and action (both exact); then, for `compare_ticks` ticks (tick 0 from the
seeded starts, the others drawn from the seed among the window's ticks,
from the program's states there), the network's first proposal and the
applied actions against the reference's forward of the whole batch on the
same states. `limits/<cell>.json` names the numbers compared.
"""
from __future__ import annotations

import gc
import random
from typing import Dict, List

import torch

from portbench import harness, ref_check

# the lanes restarted after tick t start from reset(seed + RESET_STRIDE * t)
RESET_STRIDE = 1_000_003


class Driver:
    unit = "lane-ticks"

    def __init__(self, root, config: Dict, mix: Dict, seed: int, device="cuda"):
        self.root, self.config, self.mix, self.seed = root, config, mix, seed
        self.device = torch.device(device)
        self.lanes = int(mix["lanes"])
        self.restart_every = int(mix["restart_every"])
        self.ticks: List[Dict] = []  # per tick: x_in, proposal, u, x_out, bad

    # -- the program --------------------------------------------------------
    def setup(self) -> None:
        from deqmpc_tpu_torch.envs import make_env_of
        from deqmpc_tpu_torch.policies import build_policy
        from deqmpc_tpu_torch.utils.checkpoint import load_checkpoint

        state, args = load_checkpoint(str(self.root / self.config["checkpoint"]), self.device)
        harness.check_args(self.config, args)
        self.env = make_env_of(args)
        self.policy = build_policy(args, self.env, self.device)
        self.policy.model.load_state_dict(state)
        warm = self._reset(self.seed + int(self.mix["warmup_seed_offset"]), self.lanes)
        self._tick(warm, record=False)
        self.restart(self.seed)

    def restart(self, seed: int) -> None:
        """Every lane at the start of a fresh episode drawn from `seed`."""
        self.seed, self.t, self.ticks = seed, 0, []
        self.x = self._reset(seed, self.lanes)

    def _reset(self, seed: int, n: int) -> torch.Tensor:
        return self.env.reset(torch.Generator().manual_seed(seed), n, device=self.device)

    def restarted(self, t: int) -> torch.Tensor:
        """The lanes whose episode starts again after tick t - 1."""
        return torch.arange(t % self.restart_every, self.lanes, self.restart_every)

    def _tick(self, x, record=True):
        with torch.inference_mode():
            trajs = self.policy.forward(x.float())["trajs"]
            u = trajs[-1][2][:, 0]
            x_next, reward = self.env.step(x, u)
            if record:
                self.ticks.append({"x_in": x, "proposal": trajs[0][0], "u": u,
                                   "x_out": x_next,
                                   "bad": self.env.is_bad_state(x_next, reward).sum()})
        return x_next

    def step(self) -> int:
        """One tick of every lane, then the restart of the lanes whose
        episode ends; returns the lane-ticks done."""
        x = self._tick(self.x)
        self.t += 1
        lanes = self.restarted(self.t)
        with torch.inference_mode():
            self.x = x.index_copy(0, lanes.to(self.device),
                                  self._reset(self.seed + RESET_STRIDE * self.t, len(lanes)))
        return self.lanes

    def counters(self) -> Dict[str, float]:
        p = self.policy
        return {"newton_steps": p.newton_steps, "newton_retries": p.newton_retries}

    def layer_callables(self):
        """(owner, attribute, range name) of the port's public callables that
        the traced run wraps."""
        from deqmpc_tpu_torch.solvers import newton_al

        p = self.policy
        return [(p.model, "step", "network"), (p.tracking_mpc.ctrl, "solve", "al_solve"),
                (self.env, "dynamics_derivatives", "jacobian"),
                (newton_al, "block_tridiag_solve", "b1")]

    def end_to_end(self, window) -> Dict[str, Dict]:
        return {"lane_ticks_per_s": {"value": window.rate(), "unit": "ticks/s"}}

    def failed(self, n_ticks: int) -> int:
        """Lane-ticks of the first `n_ticks` whose state went non-finite or bad."""
        return int(sum(int(t["bad"]) for t in self.ticks[:n_ticks]))

    def flops_per_step(self, per_step: Dict[str, float]) -> float:
        from portbench import flops

        c = self.config
        f_dyn, net_round = ref_check.counted_work(c)
        return flops.tick_flops(self.lanes, c["args"]["deq_iter"], net_round, c["args"]["T"],
                                c["nx"], c["nu"], f_dyn, per_step["newton_steps"],
                                per_step["newton_retries"],
                                c["args"]["deq_iter"] * c["al_iter"])

    def release(self) -> None:
        """Frees the program's state; what the check needs stays on the host."""
        for t in self.ticks:
            for k in ("x_in", "proposal", "u", "x_out"):
                t[k] = t[k].detach().cpu()
        self.x = None
        self.policy = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # -- correct ----------------------------------------------------------------
    def compare_ticks(self, n_window: int) -> List[int]:
        """Tick 0 and `compare_ticks` - 1 more drawn from the seed among the
        window's ticks."""
        k = int(self.mix["compare_ticks"])
        rest = list(range(1, n_window))
        return [0] + sorted(random.Random(self.seed).sample(rest, min(k - 1, len(rest))))

    def check(self, n_window: int, control: bool = False) -> Dict[str, float]:
        """The readings: `start_gap` (every tick's input states) and
        `step_gap`, the network's first proposal (`proposal_gap`, the largest
        over lanes and compared ticks) and the applied actions
        (`ref_check.action_gaps`). With `control`, the reference in TF32
        stands in the program's place for the proposals and the actions."""
        ticks = self.ticks[:n_window]
        ref = ref_check.Reference(self.root, self.config, self.device, tf32=False)
        want_in = [ref.reset(self.seed, self.lanes)]
        for t in range(1, len(ticks)):
            lanes = self.restarted(t)
            want_in.append(ticks[t - 1]["x_out"].cpu().index_copy(
                0, lanes, ref.reset(self.seed + RESET_STRIDE * t, len(lanes))))
        out = {"start_gap": max(float((t["x_in"].cpu() - w).abs().max())
                                for t, w in zip(ticks, want_in))}
        out["step_gap"] = max(ref.step_gap(t["x_in"], t["u"], t["x_out"]) for t in ticks)
        idx = self.compare_ticks(n_window)
        want = [ref.forward(ticks[i]["x_in"]) for i in idx]
        if control:
            ref = ref_check.Reference(self.root, self.config, self.device, tf32=True)
            got = [ref.forward(ticks[i]["x_in"]) for i in idx]
        else:
            got = [(ticks[i]["proposal"], ticks[i]["u"]) for i in idx]
        del ref
        out["proposal_gap"] = max(float(ref_check.gap(g[0].cpu(), w[0]).max())
                                  for g, w in zip(got, want))
        out.update(ref_check.action_gaps([g[1] for g in got], [w[1] for w in want]))
        return out

"""Expert-trajectory generation: the AL solver as the MPC teacher, and the
analytic teachers.

Port of `generate_mpc_expert`, `generate_cartpole2l_capture_expert`,
`generate_pendulum_energy_expert`, `generate_flying_cartpole_expert` and
`main` (`deqmpc_tpu/data/expert_gen.py:30-552`). Each teacher returns a
list of episodes, each a list of (state, action) numpy pairs, the format
of the expert pickles.

- The MPC teacher tracks the env's target and trim action (`u_trim`)
  with a `TrackingMPC` at `max_newton_steps` 8 and `rho_max` 1e8,
  warm-started tick to tick, and applies the first control. It plans on an
  unwrapped shadow state with each angle's reference snapped to the
  nearest 2 pi multiple of the target, and records the wrapped state. A
  lane whose state leaves |x| <= 50 or goes non-finite is frozen (it
  solves from the origin and keeps its state) and dropped at the end. The
  solve's inputs are cast to f32, as in JAX, and the solve runs in
  `dtype`. DART noise perturbs the stepped action only; the clean one is
  recorded.
- The capture teacher is the MPC teacher on the 2-link cartpole from
  starts near upright (horizon 60, 10 AL iterations), filtered at `tol`.
- The pendulum's energy-pumping law and the flying cartpole's cascade
  (pole energy -> world acceleration -> geometric attitude -> motor mix,
  with a capture-mode hysteresis) use no solver.

Random draws come from a `torch.Generator` seeded with `seed`, where JAX
splits a `PRNGKey`; start states given as `x0` make two runs comparable.
The noise of each 50-tick chunk of the MPC teacher is drawn at the
chunk's start, as JAX draws per chunk. The shadow state is kept in f64
whatever the solve's dtype (JAX's state under x64).

CLI (every flag of JAX's; `--out` is the port's, default
`data_port/expert_traj_<teacher>-<spec id>_new.pkl`; the committed
`data/` is never written, and `--append` onto a file that does not exist
yet starts from the committed dataset's episodes):
  python -m deqmpc_tpu_torch.data.expert_gen --env rexquadrotor --episodes 256 \
      --ep_len 100 [--cpu] [--out data_port/x.pkl]
"""
from __future__ import annotations

import argparse
import math
from typing import List, Optional

import numpy as np
import torch

from .. import resolve_device
from ..envs import make_env
from ..policies.tracking_mpc import TrackingMPC
from ..utils import angle_idxs_for_env
from ..utils.rotations import mrp2quat, mrp2rot, quatrot
from .datagen import port_data_path, write_episodes

CHUNK = 50  # ticks a noise draw covers (JAX's scan chunk, `expert_gen.py:125`)
DEAD_STATE = 50.0  # |x| beyond which a lane is frozen (`expert_gen.py:92-94`)


def _episodes(states: np.ndarray, actions: np.ndarray, keep) -> List:
    return [[(states[b, t], actions[b, t]) for t in range(states.shape[1])]
            for b in np.nonzero(keep)[0]]


def _box(env, like: torch.Tensor):
    return (torch.as_tensor(env.action_space.low, dtype=like.dtype, device=like.device),
            torch.as_tensor(env.action_space.high, dtype=like.dtype, device=like.device))


def _starts(x0, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x0), dtype=torch.float64).to(device)


def generate_mpc_expert(env, n_episodes: int = 256, ep_len: int = 200, horizon: int = 30,
                        seed: int = 0, al_iters: int = 8, rho_init_max: float = 1e4,
                        noise_std: float = 0.0, env_name: Optional[str] = None, x0=None,
                        dtype=torch.float32, device="cuda") -> List:
    """Closed-loop batched MPC rollouts (`expert_gen.py:30-153`)."""
    device = resolve_device(device)
    gen = torch.Generator().manual_seed(seed)
    if x0 is None:
        x = env.reset(gen, n_episodes, device=device, dtype=torch.float64)
    else:
        x = _starts(x0, device)
    bsz = x.shape[0]
    tracking = TrackingMPC(env, horizon, al_iter=al_iters, dtype=dtype, max_newton_steps=8,
                           rho_max=1e8, device=device)
    targ = torch.as_tensor(env.targ_pos, dtype=torch.float32, device=device)
    idxs = angle_idxs_for_env(env_name or env.spec_id, env.nx)
    idxs = None if idxs is None or len(idxs) == 0 else torch.as_tensor(idxs, device=device)
    x_ref_tile = targ.expand(bsz, horizon, env.nx)
    u_ref_tile = torch.full((bsz, horizon, env.nu), env.u_trim, dtype=torch.float32,
                            device=device)
    u_lo, u_hi = _box(env, u_ref_tile)

    def snap_ref(x):
        """The target trajectory with each angle moved to the 2 pi multiple of
        the target angle nearest the sample's, per sample."""
        if idxs is None:
            return x_ref_tile
        th, tg = x[:, idxs], targ[idxs]
        snapped = tg + 2 * math.pi * torch.round((th - tg) / (2 * math.pi))
        x_ref = x_ref_tile.clone()
        x_ref[:, :, idxs] = snapped[:, None, :].to(x_ref.dtype)
        return x_ref

    sol_state = tracking.init_state(bsz)
    xs, us, deads = [], [], []
    with torch.inference_mode():
        for lo in range(0, ep_len, CHUNK):
            n = min(CHUNK, ep_len - lo)
            noise = torch.randn((n, bsz, env.nu), generator=gen, dtype=torch.float64)
            for t in range(n):
                dead = (x.abs() > DEAD_STATE).any(dim=-1) | ~torch.isfinite(x).all(dim=-1)
                x_solve = torch.where(dead[:, None], torch.zeros_like(x), x)
                _, plan_u, _, sol_state = tracking(x_solve.float(), snap_ref(x_solve),
                                                   u_ref_tile, sol_state, al_iters=al_iters)
                u0 = torch.clamp(plan_u[:, 0], u_lo, u_hi)
                u_apply = u0
                if noise_std > 0:
                    u_apply = torch.clamp(
                        u0 + noise_std * noise[t].to(device=device, dtype=u0.dtype), u_lo, u_hi)
                x_next = env.dynamics(x, u_apply)  # no wrap on the shadow state
                xs.append(env.state_clip(x).cpu())
                us.append(u0.cpu())
                deads.append(dead.cpu())
                x = torch.where(dead[:, None], x, x_next)
                sol_state = tracking.warm_start_state(sol_state, rho_init_max)
    states = torch.stack(xs, dim=1).numpy()  # (bsz, ep_len, nx)
    actions = torch.stack(us, dim=1).numpy()
    ever_dead = torch.stack(deads, dim=1).any(dim=1).numpy()
    # non-finite lanes and lanes the freeze held: their recorded pairs are
    # garbage that state_clip's wrap and clip can hide
    ok = (np.isfinite(states).all(axis=(1, 2)) & np.isfinite(actions).all(axis=(1, 2))
          & ~ever_dead)
    return _episodes(states, actions, ok)


def capture_starts(n_episodes: int, seed: int = 0) -> np.ndarray:
    """The capture regime's starts (`expert_gen.py:175-180`): cart within
    +-1, joint angles within +-0.7 of upright, velocities within +-1,
    drawn with numpy (the same states as JAX's)."""
    rng = np.random.default_rng(seed)
    x0 = np.zeros((n_episodes, 6), np.float32)
    x0[:, 0] = rng.uniform(-1.0, 1.0, n_episodes)
    x0[:, 1:3] = rng.uniform(-0.7, 0.7, (n_episodes, 2))
    x0[:, 3:] = rng.uniform(-1.0, 1.0, (n_episodes, 3))
    return x0


def generate_cartpole2l_capture_expert(env, n_episodes: int = 256, ep_len: int = 300,
                                       horizon: int = 60, seed: int = 0, al_iters: int = 10,
                                       noise_std: float = 0.3, tol: float = 0.25, x0=None,
                                       dtype=torch.float32, device="cuda") -> List:
    """The 2-link cartpole in the capture regime, lanes kept whose final
    wrapped error is below `tol` (`expert_gen.py:156-191`)."""
    if x0 is None:
        x0 = capture_starts(n_episodes, seed)
    eps = generate_mpc_expert(env, ep_len=ep_len, horizon=horizon, al_iters=al_iters,
                              noise_std=noise_std, env_name="cartpole2link", x0=x0, seed=seed,
                              dtype=dtype, device=device)
    kept = []
    for ep in eps:
        err = np.asarray(ep[-1][0]) - np.asarray(env.targ_pos)
        err[1:3] = np.mod(err[1:3] + np.pi, 2 * np.pi) - np.pi
        if np.linalg.norm(err) < tol:
            kept.append(ep)
    return kept


def generate_pendulum_energy_expert(env, n_episodes: int = 256, ep_len: int = 200,
                                    seed: int = 0, k_e: float = 1.0, k_p: float = 30.0,
                                    k_d: float = 6.0, noise_std: float = 0.05, x0=None,
                                    device="cuda") -> List:
    """Energy pumping with a PD capture near upright (`expert_gen.py:194-256`);
    a third of the drawn starts lie near the top."""
    device = resolve_device(device)
    m, l, g = env.m, env.l, env.g
    E_des = 2 * m * g * l  # the potential at upright
    u_max = float(env.max_torque)
    gen = torch.Generator().manual_seed(seed)

    def expert_u(x, noise):
        theta, thetadot = x[..., 0], x[..., 1]
        E = 0.5 * m * l**2 * thetadot**2 + m * g * l * (1 - torch.cos(theta))
        err = torch.remainder(theta - math.pi + math.pi, 2 * math.pi) - math.pi
        # PD capture only where +-u_max can dominate gravity
        near_top = (err.abs() < 0.15) & (thetadot.abs() < 2.5)
        u_pump = k_e * (E_des - E) * torch.sign(
            torch.where(thetadot.abs() < 1e-3, torch.ones_like(thetadot), thetadot))
        u_pd = -k_p * err - k_d * thetadot
        u = torch.where(near_top, u_pd, u_pump) + noise_std * noise
        return torch.clamp(u, -u_max, u_max)[..., None]

    if x0 is None:
        x = env.reset(gen, n_episodes, device="cpu", dtype=torch.float64)
        n_catch = n_episodes // 3
        if n_catch > 0:
            th0 = math.pi + (torch.rand(n_catch, generator=gen, dtype=torch.float64) * 1.8 - 0.9)
            thd0 = torch.rand(n_catch, generator=gen, dtype=torch.float64) * 5.0 - 2.5
            x[:n_catch] = torch.stack([th0, thd0], dim=-1)
        x = x.to(device)
    else:
        x = _starts(x0, device)
    noise = torch.randn((ep_len, x.shape[0]), generator=gen, dtype=torch.float64).to(device)
    xs, us = [], []
    with torch.inference_mode():
        for t in range(ep_len):
            u = expert_u(x, noise[t])
            xs.append(x.cpu())
            us.append(u.cpu())
            x, _ = env.step(x, u)
    states = torch.stack(xs, dim=1).numpy()
    actions = torch.stack(us, dim=1).numpy()
    return _episodes(states, actions, np.ones(states.shape[0], bool))


def generate_flying_cartpole_expert(env, n_episodes: int = 256, ep_len: int = 240,
                                    seed: int = 0, noise_std: float = 0.005, x0=None,
                                    capture_kp: float = 16.0, capture_kd: float = 2.0,
                                    pos_kp: float = 0.7, pos_kv: float = 2.0,
                                    lean_max: float = 0.30, lead: float = 0.22,
                                    success_filter: bool = True, ang_tol: float = 0.25,
                                    pos_tol: float = 0.25, device="cuda") -> List:
    """The cascade teacher (`expert_gen.py:259-474`): kept are the finite
    episodes that end within `ang_tol` and `pos_tol` of the target (with
    `success_filter`) and, on an obstacle field, never enter a sphere."""
    device = resolve_device(device)
    m, L, g = env.mass, env.L, 9.81
    kf, km = env.kf, env.km
    act_scale, u_hover = env.act_scale, env.u_hover
    arms = env.motor_dist * env.ss  # (4, 3)
    # per-motor thrust -> [T, tau_x, tau_y, tau_z]
    mix = np.zeros((4, 4))
    mix[0] = 1.0
    mix[1] = arms[:, 1]
    mix[2] = -arms[:, 0]
    mix[3] = (km / kf) * np.array([1.0, -1.0, 1.0, -1.0])
    # JAX keeps J and the inverse mix in f32; their f32 values, in the state's dtype
    J32 = np.asarray(env.J, np.float32)
    mix_inv32 = np.linalg.inv(mix).astype(np.float32)
    E_star = 2 * g / L
    a_h_max = g * np.tan(np.deg2rad(28.0))  # tilt-limited lateral acceleration
    gen = torch.Generator().manual_seed(seed)

    def expert_u(x, mode, noise):
        """`mode`: per lane, whether the capture law has engaged (engage in a
        tight window, release only when the pole clearly escapes)."""
        f = dict(dtype=x.dtype, device=x.device)
        J, mix_inv = torch.as_tensor(J32, **f), torch.as_tensor(mix_inv32, **f)
        u_lo, u_hi = _box(env, x)
        r, p, th = x[..., :3], x[..., 3:6], x[..., 6]
        v, w, thd = x[..., 7:10], x[..., 10:13], x[..., 13]
        q = mrp2quat(p)
        vel_w = quatrot(q, v)  # world velocity
        R = mrp2rot(p)  # body -> world

        # the pole loop: the desired world-x acceleration
        e_th = torch.remainder(th - math.pi + math.pi, 2 * math.pi) - math.pi
        E = 0.5 * thd**2 + (g / L) * (1 - torch.cos(th))
        engage = (e_th.abs() < 0.3) & (thd.abs() < 1.6)
        release = (e_th.abs() > 0.75) | (thd.abs() > 3.5)
        near = (mode | engage) & ~release
        # bang-bang energy pump, aimed slightly above E* so the pole reaches the top
        pump_dir = thd * torch.cos(th)
        pump_dir = torch.where(pump_dir.abs() < 1e-3, torch.ones_like(pump_dir),
                               torch.sign(pump_dir))
        ax_pump = torch.clamp(1.5 * (1.005 * E_star - E).abs(), 0.3, 3.0) * pump_dir
        ax_pump = ax_pump + torch.clamp(-0.45 * r[..., 0] - 1.1 * vel_w[..., 0], -1.8, 1.8)
        # capture: position feedback through a desired lean, gated by the
        # pole's stability, with lead on the predicted error
        stab = torch.exp(-((e_th / 0.25) ** 2) - (thd / 1.2) ** 2)
        e_des = stab * torch.clamp((-pos_kp * r[..., 0] - pos_kv * vel_w[..., 0]) / g,
                                   -lean_max, lean_max)
        e_lead = e_th + lead * thd
        ax_capture = torch.clamp(capture_kp * (e_lead - e_des) + capture_kd * thd + g * e_des,
                                 -a_h_max, a_h_max)
        a_x = torch.where(near, ax_capture, ax_pump)

        # the position loop (y, z) and the tilt limiter
        a_y = torch.clamp(-1.5 * r[..., 1] - 2.2 * vel_w[..., 1], -2.0, 2.0)
        a_z = torch.clamp(-1.5 * r[..., 2] - 2.2 * vel_w[..., 2], -2.0, 2.0)
        a_lat = torch.sqrt(a_x**2 + a_y**2) + 1e-9
        scale = torch.clamp(a_h_max / a_lat, max=1.0)
        a_des = torch.stack([a_x * scale, a_y * scale, a_z], dim=-1)

        # thrust vector -> desired attitude (yaw 0)
        f_w = m * (a_des + torch.tensor([0.0, 0.0, g], **f))  # required world force
        T_des = torch.linalg.vector_norm(f_w, dim=-1)
        z_b = f_w / torch.clamp(T_des[..., None], min=1e-6)
        x_c = torch.tensor([1.0, 0.0, 0.0], **f).expand(z_b.shape)
        y_b = torch.linalg.cross(z_b, x_c, dim=-1)
        y_b = y_b / torch.clamp(torch.linalg.vector_norm(y_b, dim=-1, keepdim=True), min=1e-6)
        x_b = torch.linalg.cross(y_b, z_b, dim=-1)
        R_des = torch.stack([x_b, y_b, z_b], dim=-1)  # columns

        # geometric attitude PD
        M = R_des.mT @ R - R.mT @ R_des
        e_R = 0.5 * torch.stack([M[..., 2, 1], M[..., 0, 2], M[..., 1, 0]], dim=-1)
        Jw = w @ J.T
        tau = (-100.0 * e_R - 20.0 * w) @ J.T + torch.linalg.cross(w, Jw, dim=-1)

        # motor mixing, the thrust along the current body z
        T_body = torch.clamp(torch.sum(f_w * R[..., :, 2], dim=-1), min=0.1)
        wrench = torch.cat([T_body[..., None], tau], dim=-1)
        f_motor = wrench @ mix_inv.T  # per-motor thrust
        u = f_motor / (kf * act_scale) - u_hover + noise_std * noise
        return torch.clamp(u, u_lo, u_hi), near

    if x0 is None:
        x = env.reset(gen, n_episodes, device="cpu", dtype=torch.float64)
        n_catch = n_episodes // 3
        if n_catch > 0:
            xc = torch.zeros((n_catch, 14), dtype=torch.float64)
            xc[:, :3] = torch.rand((n_catch, 3), generator=gen, dtype=torch.float64) * 6.0 - 3.0
            xc[:, 6] = math.pi + (torch.rand(n_catch, generator=gen, dtype=torch.float64) - 0.5)
            x[:n_catch] = xc
        x = x.to(device)
    else:
        x = _starts(x0, device)
    noise = torch.randn((ep_len, x.shape[0], env.nu), generator=gen,
                        dtype=torch.float64).to(device)
    mode = torch.zeros(x.shape[0], dtype=torch.bool, device=device)
    xs, us = [], []
    with torch.inference_mode():
        for t in range(ep_len):
            u, mode = expert_u(x, mode, noise[t])
            xs.append(env.state_clip(x).cpu())
            us.append(u.cpu())
            x = env.dynamics(x, u)  # the unwrapped shadow state
    states = torch.stack(xs, dim=1).numpy()
    actions = torch.stack(us, dim=1).numpy()
    ok = np.isfinite(states).all(axis=(1, 2)) & np.isfinite(actions).all(axis=(1, 2))
    # keep only the episodes the teacher solved
    ang_f = np.abs(np.mod(states[:, -1, 6] - np.pi + np.pi, 2 * np.pi) - np.pi)
    pos_f = np.linalg.norm(states[:, -1, :3], axis=-1)
    if success_filter:
        ok &= (ang_f < ang_tol) & (pos_f < pos_tol)
    if getattr(env, "obstacles", False):
        # the cascade is obstacle-blind: keep the paths that never enter a sphere
        ok &= ~env.check_collisions(torch.as_tensor(states)).any(dim=1).numpy()
    return _episodes(states, actions, ok)


def final_distances(episodes: List, env, env_name: str) -> np.ndarray:
    """Per episode, the final state's distance to the target, the angle dims
    wrapped (JAX's quality report, `expert_gen.py:540-549`)."""
    finals = np.stack([ep[-1][0] for ep in episodes])
    err = finals - np.asarray(env.targ_pos)
    idxs = angle_idxs_for_env(env_name, env.nx)
    if idxs is not None and len(idxs) > 0:
        err[:, idxs] = np.mod(err[:, idxs] + np.pi, 2 * np.pi) - np.pi
    return np.linalg.norm(err, axis=-1)


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--env", type=str, default="pendulum")
    p.add_argument("--episodes", type=int, default=256)
    # None: each teacher's own default applies
    p.add_argument("--ep_len", type=int, default=None)
    p.add_argument("--horizon", type=int, default=None)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--teacher", type=str, default="mpc")
    p.add_argument("--cpu", action="store_true", help="run on the CPU instead of the card")
    p.add_argument("--al_iters", type=int, default=None)
    p.add_argument("--noise_std", type=float, default=None,
                   help="exploration noise of the teacher (the clean action is recorded)")
    p.add_argument("--x0_npz", type=str, default=None,
                   help="npz with array 'x0': explicit start states (DAgger's shards)")
    p.add_argument("--append", action="store_true",
                   help="append to the dataset pickle instead of overwriting it")
    p.add_argument("--out", type=str, default=None,
                   help="the pickle to write (default data_port/expert_traj_<teacher>-<spec>_new.pkl)")
    return p


def main(argv=None):
    """Returns (the path written, the episodes it holds)."""
    args = build_argparser().parse_args(argv)
    device = "cpu" if args.cpu else "cuda"
    x0 = np.load(args.x0_npz)["x0"] if args.x0_npz else None
    env = make_env(args.env)
    kw = {"x0": x0} if x0 is not None else {}
    if args.env.startswith("pendulum") and not args.env.endswith("stabilize"):
        episodes = generate_pendulum_energy_expert(
            env, n_episodes=args.episodes, seed=args.seed,
            ep_len=args.ep_len if args.ep_len is not None else 200,
            noise_std=args.noise_std if args.noise_std is not None else 0.2,
            device=device, **kw)
    elif "FlyingCartpole" in args.env:
        episodes = generate_flying_cartpole_expert(
            env, n_episodes=args.episodes, seed=args.seed,
            ep_len=args.ep_len if args.ep_len is not None else 200, device=device, **kw)
    elif args.env == "cartpole2link":
        episodes = generate_cartpole2l_capture_expert(
            env, n_episodes=args.episodes, seed=args.seed, device=device, **kw,
            **{k: getattr(args, k) for k in ("ep_len", "horizon", "al_iters", "noise_std")
               if getattr(args, k) is not None})
    else:
        episodes = generate_mpc_expert(
            env, n_episodes=args.episodes, seed=args.seed, env_name=args.env,
            ep_len=args.ep_len if args.ep_len is not None else 200,
            horizon=args.horizon if args.horizon is not None else 30,
            al_iters=args.al_iters if args.al_iters is not None else 2,
            noise_std=args.noise_std if args.noise_std is not None else 0.2,
            x0=x0, device=device)
    path = args.out or port_data_path(env.spec_id, args.teacher)
    episodes = write_episodes(path, episodes, append=args.append, spec_id=env.spec_id,
                              teacher=args.teacher)
    d = final_distances(episodes, env, args.env)
    print(f"wrote {len(episodes)} episodes to {path}")
    print(f"final |x - targ|: mean {d.mean():.3f} median {np.median(d):.3f}", flush=True)
    return path, episodes


if __name__ == "__main__":
    main()

"""The reference of one gym-style env step with its automatic reset.

A decision step holds the power action for ``tti_per_step`` TTIs; the
observation is the mean delivered throughput over the window and the
residual backlog; the reward is the geometric-mean goodput minus a
queueing penalty (full-buffer UEs exempt); ``done`` once the TTI counter
reaches the horizon, when the returned state is the fresh episode of the
reset seed and the returned observation, reward and telemetry are those
of the finished window.
"""
from __future__ import annotations

import torch

from . import telemetry


def expand_action(p, action):
    """(n_cells, n_subbands) watts -> (n_cells, n_freq): each cell's total
    clamped to the budget, each subband split over its CQI chunks."""
    total = action.sum(dim=-1, keepdim=True)
    action = action * torch.clamp(p.power_W / torch.clamp(total, min=1e-30),
                                  max=1.0)
    s = p.n_rb_subbands
    if s > 1:
        action = torch.repeat_interleave(action, s, dim=-1) / s
    return action


def reward(tput, backlog):
    goodput = torch.log(torch.clamp(tput, min=1e3)).mean()
    queue = torch.where(torch.isfinite(backlog), torch.log1p(backlog / 1e4),
                        0.0)
    return goodput - 0.05 * queue.mean()


def fresh_state(su, seed: int, device) -> dict:
    """The reset template: the set-up's positions, backlog and stationary
    PF average, empty HARQ processes, attachment-serving, t = 0."""
    n = su.U.shape[0]
    i32 = torch.int32
    return {"U": su.U.clone(), "backlog": su.backlog.clone(),
            "pf_avg": su.pf_avg.clone(),
            "rr_cursor": torch.tensor(0, dtype=i32, device=device),
            "harq_bits": torch.zeros((n,), dtype=torch.float32,
                                     device=device),
            "harq_retx": torch.zeros((n,), dtype=i32, device=device),
            "serving": su.a.clone().to(i32),
            "ttt": torch.zeros((n,), dtype=i32, device=device),
            "t": torch.tensor(0, dtype=i32, device=device)}


def step_autoreset(ref, su, s_in: dict, seed: int, action, reset_seed: int,
                   episode_tti: int, tti_per_step: int) -> dict:
    """One env step from ``s_in`` of the episode of ``seed``; the
    reference's outputs of the step."""
    state = {k: v.clone() for k, v in s_in.items()}
    power = expand_action(ref.p, action.to(torch.float32))
    stepped, tput, telems = ref.rollout(su, state, tti_per_step, seed,
                                        action=power)
    obs_tput = tput.mean(dim=0)
    backlog = stepped["backlog"]
    done = bool(stepped["t"] >= episode_tti)
    s_out = fresh_state(su, reset_seed, ref.device) if done else stepped
    return {"s_out": s_out, "obs_tput": obs_tput, "backlog": backlog,
            "reward": float(reward(obs_tput, backlog)), "done": done,
            "telem": telemetry.stack(telems)}

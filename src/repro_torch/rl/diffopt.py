"""First-order power-plan optimisation through the differentiable engine.

The port of ``repro.rl.diffopt``, with ``torch.autograd`` in place of
``jax.grad``.  The engine's ``rollout`` built with a
``sim.radio.RelaxConfig`` is differentiable end to end: argmax attachment
becomes a temperature softmax over log-RSRP, the CQI staircase a
sigmoid-sum surrogate (or straight-through), the max_cqi scheduler a
softmax share.  The relaxed chain is the torch one: the fused kernel has
no backward.

The optimizer works on an action trajectory ``u_plan`` of shape
(n_segments, n_cells, n_subbands): segment ``i``'s unconstrained entries
are squashed to watts (sigmoid times the budget clamp, the env's own
convention) and held for ``tti_per_segment`` TTIs.  Ascent is on the
relaxed objective; progress is scored on the un-relaxed engine with the
same draws, so the reported number is the real simulator's throughput.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch.env.crrm_env import expand_action
from repro_torch.mac.engine import Draws
from repro_torch.sim.radio import RelaxConfig
from repro_torch.train import optim


def plan_to_power(params, u_plan):
    """Unconstrained (..., n_cells, n_subbands) -> engine power grids:
    ``power_W * sigmoid(u)`` per entry, then the budget clamp and the
    subband-chunk split of ``env.crrm_env.expand_action``."""
    return expand_action(params, params.power_W * torch.sigmoid(u_plan))


def make_power_objective(sim, *, tti_per_segment: int = 10,
                         relax: RelaxConfig | None = RelaxConfig(),
                         seed: int = 0, draws=None):
    """``(soft_objective, hard_objective)``: ``u_plan -> mean served
    Mbit/s`` on the relaxed engine (differentiable) and on the legacy
    engine (the scoreboard, run without autograd).  Both roll the plan's
    segments from the same initial state of episode ``seed`` on the same
    draws (``draws``, default ``Draws(seed, sim.device)``), so their
    values meet as ``relax`` tightens."""
    fns_soft = sim.episode_fns(radio_mode="dense", relax=relax)
    fns_hard = sim.episode_fns(radio_mode="dense")
    static = sim.episode_static()
    state0 = sim.init_episode_state(seed)
    draws = Draws(seed, sim.device) if draws is None else draws

    def build(fns):
        def objective(u_plan):
            state, seg_tput = state0, []
            for u in u_plan:
                power = plan_to_power(sim.params, u)
                state, tput = fns.rollout(static, state, tti_per_segment,
                                          draws, power)
                seg_tput.append(tput.mean())
            return torch.stack(seg_tput).mean() / 1e6   # Mbit/s, O(1)
        return objective

    return build(fns_soft), torch.no_grad()(build(fns_hard))


class DiffOptResult(NamedTuple):
    u_plan: Any         # optimised unconstrained trajectory
    power_plan: Any     # its (n_segments, n_cells, n_freq) watt grids
    history: list       # per-step dicts: soft/hard objective, grad norm


def optimize_power_plan(sim, *, n_segments: int = 4,
                        tti_per_segment: int = 10, steps: int = 40,
                        lr: float = 0.1,
                        relax: RelaxConfig | None = RelaxConfig(),
                        seed: int = 0, score_every: int = 5,
                        verbose: bool = False) -> DiffOptResult:
    """Gradient-ascend a power-plan trajectory for ``sim``.

    Starts from the uniform plan (``u = 0``: half the budget per subband,
    the clamp inactive), takes ``steps`` Adam steps on the relaxed
    served-throughput objective, and scores the exact engine every
    ``score_every`` steps.
    """
    soft_obj, hard_obj = make_power_objective(
        sim, tti_per_segment=tti_per_segment, relax=relax, seed=seed)
    opt = optim.adamw(optim.constant_lr(lr), weight_decay=0.0,
                      grad_clip=10.0)
    u = torch.zeros((n_segments, sim.n_cells, sim.params.n_subbands),
                    dtype=torch.float32, device=sim.device)
    opt_state = opt.init(u)
    history = []
    for step in range(steps):
        leaf = u.detach().requires_grad_(True)
        value = soft_obj(leaf)
        (grad,) = torch.autograd.grad(value, leaf)
        # ascent: the optimizer minimises, so feed it the negated gradient
        with torch.no_grad():
            u, opt_state, stats = opt.update(-grad, opt_state, u)
        rec = {"step": step, "soft_mbps": float(value.detach()),
               "grad_norm": float(stats["grad_norm"])}
        if score_every and step % score_every == 0:
            rec["hard_mbps"] = float(hard_obj(u))
        history.append(rec)
        if verbose and "hard_mbps" in rec:
            print(f"# diffopt step {step}: soft {rec['soft_mbps']:.3f} "
                  f"hard {rec['hard_mbps']:.3f} Mbit/s "
                  f"|g| {rec['grad_norm']:.2e}")
    with torch.no_grad():
        history.append({"step": steps, "soft_mbps": float(soft_obj(u)),
                        "hard_mbps": float(hard_obj(u)), "grad_norm": 0.0})
        power_plan = plan_to_power(sim.params, u)
    return DiffOptResult(u_plan=u, power_plan=power_plan, history=history)

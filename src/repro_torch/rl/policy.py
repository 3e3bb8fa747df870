"""MLP actor-critic over the CRRM power-control surface.

The port of ``repro.rl.policy``.  Everything is a function of an explicit
``params`` tree -- a plain dict with the reference's keys and leaf order
(``actor``, ``critic``, ``layers``, ``log_std``), so the checkpoint and
``repro_torch.convert`` read it as they read the reference's.  Every
function takes leading batch axes: ``feat`` (..., feature_dim) gives
(..., action_dim) actions and (...) values, where the reference maps one
episode at a time with ``vmap``.

The observation (:func:`features`): per-cell serving KPIs of the previous
decision window (delivered Mbit/s and granted-RB share per cell, from the
env's ``reward_components``; zero at an episode start) plus four global
statistics of the UE population.

The Gaussian policy lives in an unconstrained space ``u``; actions are
squashes of the sample (:func:`squash_power` to ``(0, power_W)`` per
cell/subband, :func:`squash_fairness` to the alpha-fairness interval).
PPO's ratios are taken on ``u``, so the squash Jacobians cancel.

Randomness: :func:`init_policy` and :func:`sample_action` draw standard
normals from a ``torch.Generator`` the caller passes, or take the normals
themselves (``noise=``), which is how the parity tests hand them the
reference's draws.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch


class PolicyConfig(NamedTuple):
    """Hashable description of the actor-critic.

    ``learn_fairness`` appends the PF alpha-fairness exponent to the
    action vector (squashed into ``fairness_range``); off, the action is
    the (n_cells, n_subbands) power matrix alone.
    """

    n_cells: int
    n_subbands: int
    power_W: float
    hidden: tuple = (64, 64)
    learn_fairness: bool = False
    fairness_range: tuple = (0.0, 2.0)
    init_log_std: float = -0.5


def action_dim(cfg: PolicyConfig) -> int:
    return cfg.n_cells * cfg.n_subbands + (1 if cfg.learn_fairness else 0)


def feature_dim(cfg: PolicyConfig) -> int:
    return 2 * cfg.n_cells + 4


def features(cfg: PolicyConfig, obs, cell_tput_mbps=None,
             cell_granted_rb=None):
    """The policy input (..., feature_dim) of an observation (leaves
    (..., n_ues)).  ``cell_tput_mbps`` / ``cell_granted_rb`` (...,
    n_cells) are the previous window's per-cell reward components (None
    at an episode start: zeros)."""
    lead = obs.tput.shape[:-1]
    zc = torch.zeros(lead + (cfg.n_cells,), dtype=torch.float32,
                     device=obs.tput.device)
    ct = zc if cell_tput_mbps is None else cell_tput_mbps
    cg = zc if cell_granted_rb is None else cell_granted_rb
    log_t = torch.log1p(torch.clamp(obs.tput, min=0.0) / 1e6)
    finite = torch.isfinite(obs.backlog)
    log_b = torch.where(finite, torch.log1p(
        torch.where(finite, obs.backlog, 0.0) / 1e4), 0.0)
    return torch.cat([
        torch.log1p(torch.clamp(ct, min=0.0)),
        cg / 100.0,
        torch.stack([log_t.mean(dim=-1), log_t.std(dim=-1, correction=0),
                     log_b.mean(dim=-1),
                     finite.to(torch.float32).mean(dim=-1)], dim=-1),
    ], dim=-1).to(torch.float32)


def init_noise_shapes(cfg: PolicyConfig) -> list:
    """The shapes of :func:`init_policy`'s standard normals, in draw
    order: each hidden layer's weight, then the actor's and the critic's."""
    sizes = (feature_dim(cfg),) + tuple(cfg.hidden)
    return ([(n_in, n_out) for n_in, n_out in zip(sizes[:-1], sizes[1:])]
            + [(sizes[-1], action_dim(cfg)), (sizes[-1], 1)])


def init_policy(gen, cfg: PolicyConfig, *, noise=None, device=None):
    """Scaled-normal init (He for the hidden layers, a small actor head so
    the initial policy stays near the uniform plan).  The normals come from
    ``gen`` (a ``torch.Generator``; the params land on its device) or, when
    given, from ``noise``: a list shaped as :func:`init_noise_shapes`."""
    shapes = init_noise_shapes(cfg)
    if noise is None:
        device = gen.device
        noise = [torch.randn(s, generator=gen, dtype=torch.float32,
                             device=device) for s in shapes]
    else:
        device = noise[0].device if device is None else device
        noise = [torch.as_tensor(n, dtype=torch.float32, device=device)
                 for n in noise]
    f32 = dict(dtype=torch.float32, device=device)
    params = {"layers": [],
              "log_std": torch.full((action_dim(cfg),), cfg.init_log_std,
                                    **f32)}
    for (n_in, n_out), z in zip(shapes[:-2], noise[:-2]):
        params["layers"].append({"w": z * math.sqrt(2.0 / n_in),
                                 "b": torch.zeros((n_out,), **f32)})
    params["actor"] = {"w": noise[-2] * 0.01,
                       "b": torch.zeros((action_dim(cfg),), **f32)}
    params["critic"] = {"w": noise[-1] * 0.1,
                        "b": torch.zeros((1,), **f32)}
    return params


def policy_apply(cfg: PolicyConfig, params, feat):
    """feat (..., feature_dim) -> (mean_u (..., action_dim), log_std
    (action_dim,), value (...))."""
    h = feat
    for layer in params["layers"]:
        h = torch.tanh(h @ layer["w"] + layer["b"])
    mean_u = h @ params["actor"]["w"] + params["actor"]["b"]
    value = (h @ params["critic"]["w"] + params["critic"]["b"])[..., 0]
    log_std = torch.clamp(params["log_std"], -5.0, 1.0)
    return mean_u, log_std, value


def squash_power(cfg: PolicyConfig, u_power):
    """Unconstrained (..., n_cells*n_subbands) -> (..., n_cells,
    n_subbands) watts: ``power_W * sigmoid(u)`` per entry; the env's
    budget clamp (``env.crrm_env.expand_action``) then holds each cell's
    total, so every sampled action is feasible."""
    p = cfg.power_W * torch.sigmoid(u_power)
    return p.reshape(p.shape[:-1] + (cfg.n_cells, cfg.n_subbands))


def squash_fairness(cfg: PolicyConfig, u_fair):
    lo, hi = cfg.fairness_range
    return lo + (hi - lo) * torch.sigmoid(u_fair)


def split_action(cfg: PolicyConfig, u):
    """u (..., action_dim) -> (power (..., n_cells, n_subbands),
    fairness (...) | None)."""
    n_p = cfg.n_cells * cfg.n_subbands
    power = squash_power(cfg, u[..., :n_p])
    fair = squash_fairness(cfg, u[..., n_p]) if cfg.learn_fairness else None
    return power, fair


def _gauss_logp(u, mean_u, log_std):
    z = (u - mean_u) * torch.exp(-log_std)
    return torch.sum(-0.5 * z * z - log_std - 0.5 * math.log(2.0 * math.pi),
                     dim=-1)


def sample_action(cfg: PolicyConfig, params, feat, gen=None, noise=None):
    """The behaviour action ``(u, power, fairness, logp, value)``: ``u =
    mean + exp(log_std) * z`` with standard normals ``z`` from ``gen`` or
    given as ``noise`` (shaped like the mean)."""
    mean_u, log_std, value = policy_apply(cfg, params, feat)
    if noise is None:
        noise = torch.randn(mean_u.shape, generator=gen, dtype=torch.float32,
                            device=mean_u.device)
    u = mean_u + torch.exp(log_std) * noise
    power, fair = split_action(cfg, u)
    return u, power, fair, _gauss_logp(u, mean_u, log_std), value


def logp_entropy(cfg: PolicyConfig, params, feat, u):
    """Re-evaluate stored samples under (new) params, PPO's ratio path:
    ``(logp (...), entropy (...), value (...))``."""
    mean_u, log_std, value = policy_apply(cfg, params, feat)
    logp = _gauss_logp(u, mean_u, log_std)
    entropy = torch.sum(log_std + 0.5 * math.log(2.0 * math.pi * math.e))
    return logp, entropy.expand(logp.shape), value


def mean_action(cfg: PolicyConfig, params, feat):
    """The deterministic (evaluation-time) action: the squashed mean."""
    mean_u, _, _ = policy_apply(cfg, params, feat)
    return split_action(cfg, mean_u)

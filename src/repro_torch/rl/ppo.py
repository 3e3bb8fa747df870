"""PPO over population-batched CRRM rollouts.

The port of ``repro.rl.ppo``: GAE advantages, the clipped surrogate and a
few epochs of full-batch gradient steps, with collection from
``rl.rollout``, the optimizer ``train.optim.adamw`` and ``torch.autograd``
for the gradients.  The whole training state -- policy params, Adam
moments, the live env states and features, the run seed and the iteration
counter -- is one tree (:class:`TrainState`) that ``train.checkpoint``
saves.  Every draw of an iteration comes from ``rollout.RolloutDraws``
keyed on (seed, iteration, step), so restoring a checkpoint and going on
gives the uninterrupted run bit for bit (on the card in PyTorch's
deterministic mode, so that ``index_add_`` adds in a fixed order).

CLI::

    PYTHONPATH=src python -m repro_torch.rl.ppo --scenario dense_urban --smoke

runs on the card (``--device cpu`` on the CPU).
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch.rl import policy as pol
from repro_torch.rl import rollout as ro
from repro_torch.train import optim
from repro_torch.tree import flatten, unflatten


class PPOConfig(NamedTuple):
    """Hashable PPO hyper-parameters."""

    n_envs: int = 8           # parallel episode streams (the batch axis)
    n_steps: int = 16         # decision steps collected per iteration
    gamma: float = 0.95       # discount per decision step
    gae_lambda: float = 0.95
    clip_eps: float = 0.2
    vf_coef: float = 0.5
    ent_coef: float = 1e-3
    lr: float = 3e-3
    epochs: int = 4           # full-batch passes per iteration
    grad_clip: float = 0.5


class TrainState(NamedTuple):
    """Everything PPO threads -- one checkpointable tree.  The reference's
    PRNG ``key`` is the int64 run ``seed`` here: with ``iteration`` it
    keys every draw of the next iteration."""

    params: Any       # policy/critic weights
    opt_state: Any    # Adam moments
    env_states: Any   # live batched EpisodeState carry
    feats: Any        # (n_envs, feature_dim) current policy inputs
    seed: Any         # int64 scalar: the run seed
    iteration: Any    # int32 scalar


def _optimizer(cfg: PPOConfig):
    return optim.adamw(optim.constant_lr(cfg.lr), weight_decay=0.0,
                       grad_clip=cfg.grad_clip)


def ppo_init(env, pcfg: pol.PolicyConfig, cfg: PPOConfig,
             seed: int = 0) -> TrainState:
    """Fresh training state: policy init + ``n_envs`` reset episodes, from
    the run's ``rollout.RolloutDraws``."""
    d = ro.RolloutDraws(seed, env.device)
    params = pol.init_policy(d.init_generator(), pcfg)
    states, obs = env.reset_batch(d.initial_seeds(cfg.n_envs))
    feats = ro.initial_features(env, pcfg, obs)
    return TrainState(
        params=params, opt_state=_optimizer(cfg).init(params),
        env_states=states, feats=feats,
        seed=torch.tensor(int(seed), dtype=torch.int64, device=env.device),
        iteration=torch.zeros((), dtype=torch.int32, device=env.device))


def gae(reward, value, done, last_value, gamma: float, lam: float):
    """Generalised advantage estimation over a time-major batch.

    ``done`` cuts the bootstrap at episode boundaries.  Returns
    ``(advantages, returns)`` of shape (T, B).
    """
    v_next = torch.cat([value[1:], last_value[None]], dim=0)
    adv = torch.zeros_like(last_value)
    out = []
    for t in reversed(range(reward.shape[0])):
        mask = 1.0 - done[t].to(torch.float32)
        delta = reward[t] + gamma * v_next[t] * mask - value[t]
        adv = delta + gamma * lam * mask * adv
        out.append(adv)
    adv = torch.stack(out[::-1])
    return adv, adv + value


def ppo_loss(params, pcfg: pol.PolicyConfig, cfg: PPOConfig, batch):
    """Clipped-surrogate + value + entropy loss over flattened samples:
    ``(loss, metrics)``."""
    feat, u, logp_old, adv, ret = batch
    logp, ent, value = pol.logp_entropy(pcfg, params, feat, u)
    ratio = torch.exp(logp - logp_old)
    adv_n = (adv - adv.mean()) / (adv.std(correction=0) + 1e-8)
    surrogate = torch.minimum(
        ratio * adv_n,
        torch.clamp(ratio, 1.0 - cfg.clip_eps, 1.0 + cfg.clip_eps) * adv_n)
    pi_loss = -surrogate.mean()
    v_loss = torch.square(value - ret).mean()
    loss = pi_loss + cfg.vf_coef * v_loss - cfg.ent_coef * ent.mean()
    return loss, {"loss": loss, "pi_loss": pi_loss, "v_loss": v_loss,
                  "entropy": ent.mean(),
                  "approx_kl": (logp_old - logp).mean()}


def _detached(metrics):
    return {k: v.detach() for k, v in metrics.items()}


def ppo_update(pcfg: pol.PolicyConfig, cfg: PPOConfig, params, opt_state,
               traj, last_value):
    """The learning half of an iteration: GAE over ``traj``, then
    ``cfg.epochs`` full-batch Adam steps on :func:`ppo_loss`.  Returns
    ``(params, opt_state, metrics)``; the metrics (0-dim tensors) are the
    last epoch's, taken before its step, plus the mean collected reward
    and value."""
    opt = _optimizer(cfg)
    adv, ret = gae(traj.reward, traj.value, traj.done, last_value,
                   cfg.gamma, cfg.gae_lambda)
    batch = tuple(x.reshape((-1,) + x.shape[2:])
                  for x in (traj.feat, traj.u, traj.logp, adv, ret))
    with torch.no_grad():
        metrics = _detached(ppo_loss(params, pcfg, cfg, batch)[1])
    for _ in range(cfg.epochs):
        leaves = [x.detach().requires_grad_(True)
                  for x in flatten(params)[1]]
        loss, m = ppo_loss(unflatten(params, leaves), pcfg, cfg, batch)
        grads = torch.autograd.grad(loss, leaves)
        with torch.no_grad():
            params, opt_state, _ = opt.update(
                unflatten(params, list(grads)), opt_state,
                unflatten(params, [x.detach() for x in leaves]))
        metrics = _detached(m)
    metrics = dict(metrics, mean_reward=traj.reward.mean(),
                   mean_value=traj.value.mean())
    return params, opt_state, metrics


def make_train_step(env, pcfg: pol.PolicyConfig, cfg: PPOConfig,
                    draws=ro.RolloutDraws):
    """One PPO iteration: collect, then :func:`ppo_update`.

    ``TrainState -> (TrainState, metrics)``; the metrics also hold the
    mean collected reward.  ``draws(seed, device)`` gives the run's draws
    (``rollout.RolloutDraws``; the parity tests replay the reference's).
    """
    collect = ro.make_collect_fn(env, pcfg, cfg.n_steps)

    def train_step(ts: TrainState):
        d = draws(int(ts.seed), env.device)
        env_states, feats, traj, last_value = collect(
            ts.params, ts.env_states, ts.feats, d, int(ts.iteration))
        params, opt_state, metrics = ppo_update(
            pcfg, cfg, ts.params, ts.opt_state, traj, last_value)
        return TrainState(params=params, opt_state=opt_state,
                          env_states=env_states, feats=feats, seed=ts.seed,
                          iteration=ts.iteration + 1), metrics

    return train_step


def train(env, pcfg: pol.PolicyConfig, cfg: PPOConfig, iterations: int,
          seed: int = 0, ckpt_dir: str | None = None,
          ckpt_every: int = 0, log_every: int = 0):
    """Run (or resume) a PPO training loop; returns (TrainState, history).

    With ``ckpt_dir``, training resumes from the latest checkpoint if one
    exists and saves every ``ckpt_every`` iterations; the whole
    :class:`TrainState` is the checkpoint, so a resumed run goes on exactly
    where it stopped.
    """
    from repro_torch.train import checkpoint

    ts = ppo_init(env, pcfg, cfg, seed)
    if ckpt_dir is not None:
        latest = checkpoint.latest_step(ckpt_dir)
        if latest is not None:
            ts, _ = checkpoint.restore(ckpt_dir, latest, ts)
    step_fn = make_train_step(env, pcfg, cfg)
    history = []
    for it in range(int(ts.iteration), iterations):
        ts, metrics = step_fn(ts)
        metrics = {k: float(v) for k, v in metrics.items()}
        history.append(metrics)
        if log_every and (it + 1) % log_every == 0:
            print(f"# ppo iter {it + 1}/{iterations} "
                  f"reward {metrics['mean_reward']:.4f} "
                  f"loss {metrics['loss']:.4f} "
                  f"kl {metrics['approx_kl']:.2e}")
        if ckpt_dir is not None and ckpt_every \
                and (it + 1) % ckpt_every == 0:
            checkpoint.save(ckpt_dir, it + 1, ts)
    return ts, history


@torch.no_grad()
def evaluate_uplift(env, pcfg: pol.PolicyConfig, params, seed: int,
                    n_steps: int = 8):
    """Served-throughput uplift of the learned plan over fixed power.

    Rolls the episode of ``seed`` twice from reset -- under the policy's
    deterministic mean action (features threaded step to step), and under
    the uniform fixed-power plan -- and compares the total served bits
    (telemetry, not the shaped reward).  Returns ``(uplift_ratio,
    learned_mbits, fixed_mbits)``.
    """
    def run(use_policy):
        state, obs = env.reset(seed)
        feat = pol.features(pcfg, obs)
        total = torch.zeros((), dtype=torch.float32, device=env.device)
        for _ in range(n_steps):
            power, fair = pol.mean_action(pcfg, params, feat)
            if not use_policy:
                power, fair = env.uniform_action(), None
            state, obs, _, _, info = env.step(state, power, fair)
            rc = info["reward_components"]
            total = total + info["telemetry"].served_bits.sum()
            feat = pol.features(pcfg, obs, rc["cell_tput_mbps"],
                                rc["cell_granted_rb"])
        return total

    learned = float(run(True)) / 1e6
    fixed = float(run(False)) / 1e6
    return learned / max(fixed, 1e-12), learned, fixed


def served_tput_reward(obs):
    """Mean delivered throughput in Mbit/s: the uplift's own metric as the
    training signal."""
    return obs.tput.mean() / 1e6


def train_power_baseline(scenario: str = "dense_urban", *, n_ues: int = 12,
                         iterations: int = 60, eval_every: int = 5,
                         seed: int = 0, lr: float = 1e-2,
                         init_log_std: float = 0.0, n_envs: int = 4,
                         n_steps: int = 8, tti_per_step: int = 5,
                         episode_tti: int = 40,
                         arrival_rate_hz: float = 2000.0,
                         scenario_overrides: dict | None = None,
                         learn_fairness: bool = False,
                         ckpt_dir: str | None = None,
                         verbose: bool = False, device=None) -> dict:
    """Train a per-scenario power-control baseline with eval selection.

    The recipe of ``benchmarks/BENCH_rl.json``: traffic saturated
    (``arrival_rate_hz`` past the serveable load, so throughput is
    interference-limited and the power plan has leverage), PPO on the
    served-throughput reward, the deterministic policy evaluated against
    the uniform fixed-power plan every ``eval_every`` iterations on the
    episode of seed ``seed + 1``, and the best iterate kept.  Returns a
    dict with ``best_uplift``, ``final_uplift``, ``best_params``,
    ``history`` and the env/config objects.  ``device`` is the env's
    (``None``: the card).
    """
    from repro_torch.env import CrrmEnv
    from repro_torch.train import checkpoint

    ov = dict(n_ues=n_ues,
              traffic_params=dict(arrival_rate_hz=arrival_rate_hz,
                                  packet_size_bits=12_000.0))
    ov.update(scenario_overrides or {})
    env = CrrmEnv(scenario=scenario, scenario_overrides=ov,
                  episode_tti=episode_tti, tti_per_step=tti_per_step,
                  telemetry=True, reward_fn=served_tput_reward,
                  device=device)
    pcfg = pol.PolicyConfig(n_cells=env.n_cells,
                            n_subbands=env.n_subbands,
                            power_W=env.max_cell_power_W,
                            learn_fairness=learn_fairness,
                            init_log_std=init_log_std)
    cfg = PPOConfig(n_envs=n_envs, n_steps=n_steps, lr=lr)
    step_fn = make_train_step(env, pcfg, cfg)
    ts = ppo_init(env, pcfg, cfg, seed)
    if ckpt_dir is not None:
        latest = checkpoint.latest_step(ckpt_dir)
        if latest is not None:
            ts, _ = checkpoint.restore(ckpt_dir, latest, ts)

    eval_seed = seed + 1
    history, best = [], {"uplift": -float("inf"), "params": ts.params,
                         "iteration": 0}
    for it in range(int(ts.iteration), iterations):
        ts, metrics = step_fn(ts)
        rec = {k: float(v) for k, v in metrics.items()}
        if (it + 1) % eval_every == 0 or it + 1 == iterations:
            uplift, learned, fixed = evaluate_uplift(env, pcfg, ts.params,
                                                     eval_seed)
            rec.update(uplift=uplift, learned_mbits=learned,
                       fixed_mbits=fixed)
            if uplift > best["uplift"]:
                best = {"uplift": uplift, "params": ts.params,
                        "iteration": it + 1}
            if verbose:
                print(f"# ppo[{scenario}] iter {it + 1}/{iterations}: "
                      f"reward {rec['mean_reward']:.3f} "
                      f"uplift x{uplift:.3f}")
            if ckpt_dir is not None:
                checkpoint.save(ckpt_dir, it + 1, ts)
        history.append(rec)
    evals = [r for r in history if "uplift" in r]
    if not evals:
        # resumed past the last iteration: nothing trained this call, so
        # score the restored params once to keep the result contract
        uplift, learned, fixed = evaluate_uplift(env, pcfg, ts.params,
                                                 eval_seed)
        best = {"uplift": uplift, "params": ts.params,
                "iteration": int(ts.iteration)}
        evals = [{"uplift": uplift, "learned_mbits": learned,
                  "fixed_mbits": fixed}]
    return {"scenario": scenario, "env": env, "pcfg": pcfg, "cfg": cfg,
            "train_state": ts, "history": history,
            "best_uplift": best["uplift"], "best_params": best["params"],
            "best_iteration": best["iteration"],
            "final_uplift": evals[-1]["uplift"],
            "fixed_mbits": evals[-1].get("fixed_mbits")}


# ------------------------------------------------------------------ CLI
def main(argv=None):
    import argparse
    import math

    ap = argparse.ArgumentParser(description="PPO power-control baseline")
    ap.add_argument("--scenario", default="dense_urban")
    ap.add_argument("--n-ues", type=int, default=24)
    ap.add_argument("--iterations", type=int, default=80)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--learn-fairness", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    ap.add_argument("--smoke", action="store_true",
                    help="tiny shapes + assertions (CI)")
    args = ap.parse_args(argv)

    if args.smoke:
        args.n_ues, args.iterations = 12, 45
    out = train_power_baseline(args.scenario, n_ues=args.n_ues,
                               iterations=args.iterations,
                               seed=args.seed, ckpt_dir=args.ckpt_dir,
                               learn_fairness=args.learn_fairness,
                               verbose=True, device=args.device)
    print(f"# ppo[{args.scenario}]: best uplift x{out['best_uplift']:.3f} "
          f"(iter {out['best_iteration']}), final "
          f"x{out['final_uplift']:.3f}")
    if args.smoke:
        if not all(math.isfinite(m["loss"]) for m in out["history"]):
            raise SystemExit("PPO smoke: non-finite loss")
        if not out["best_uplift"] > 1.0:
            raise SystemExit(
                f"PPO smoke: learned policy never beat fixed power "
                f"(best x{out['best_uplift']:.3f})")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

"""The port's RL stack (``repro_torch.rl``) against the JAX package.

Mirrors ``tests/test_rl.py``'s PPO and diffopt contracts and holds the
port to the reference on the same inputs:

* the policy: ``init_policy`` fed the reference's normals, ``features``,
  ``policy_apply``, ``sample_action`` fed the reference's noise and
  ``logp_entropy`` -- rtol 1e-6 (atol 1e-6 where a value is ~0: the
  matmuls add in another order);
* one PPO iteration against the reference's: tests/test_torch_rl_ppo.py;
* a checkpoint resume is bit for bit; ``make_collect_fn`` without
  telemetry raises; ``train_power_baseline`` keeps its result-dict and
  resume contract at micro shapes;
* ``optimize_power_plan`` ascends the soft objective within the budget,
  and its soft objective at ``u = 0`` equals the reference's (rtol 1e-5)
  on the reference's draws.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.env.crrm_env import EnvObs as JObs
from repro.rl import diffopt as j_diffopt
from repro.rl import policy as j_pol
from repro.sim.scenarios import make_scenario
from repro_torch import convert
from repro_torch import rl as t_rl
from repro_torch.env.crrm_env import CrrmEnv as TEnv
from repro_torch.env.crrm_env import EnvObs
from repro_torch.rl import diffopt as t_diffopt
from repro_torch.rl import policy as t_pol
from repro_torch.rl import ppo as t_ppo
from repro_torch.tree import flatten
from torch_parity import DEV, ReplayDraws, np_, pair

ENV = dict(episode_tti=8, tti_per_step=4, telemetry=True)


def t_(x):
    return torch.as_tensor(np.array(x))


def jtree_np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def assert_tree_close(t_tree, j_tree, rtol, atol):
    keys, got = flatten(t_tree)
    want = jax.tree_util.tree_leaves(j_tree)
    assert len(got) == len(want)
    for k, g, w in zip(keys, got, want):
        np.testing.assert_allclose(np_(g), np.asarray(w), rtol=rtol,
                                   atol=atol, err_msg=k)


def pcfg_of(env, **kw):
    return t_pol.PolicyConfig(n_cells=env.n_cells, n_subbands=env.n_subbands,
                              power_W=env.max_cell_power_W, **kw)


def init_noise(key, cfg):
    """The standard normals ``repro.rl.policy.init_policy`` draws from
    ``key``, in the port's order (``policy.init_noise_shapes``)."""
    shapes = t_pol.init_noise_shapes(cfg)
    keys = jax.random.split(key, len(cfg.hidden) + 2)
    k_pi, k_v = jax.random.split(keys[-1])
    ks = list(keys[:len(shapes) - 2]) + [k_pi, k_v]
    return [np.array(jax.random.normal(k, s, jnp.float32))
            for k, s in zip(ks, shapes)]


# ---------------------------------------------------------------- policy
@pytest.mark.parametrize("learn_fairness", [False, True])
def test_policy_matches_reference(learn_fairness):
    cfg = t_pol.PolicyConfig(n_cells=7, n_subbands=2, power_W=6.3,
                             hidden=(16, 16), learn_fairness=learn_fairness)
    key = jax.random.PRNGKey(3)
    p_j = j_pol.init_policy(key, cfg)
    p_t = t_pol.init_policy(None, cfg, noise=init_noise(key, cfg))
    assert_tree_close(p_t, p_j, rtol=1e-6, atol=0)
    assert flatten(p_t)[0] == ["actor/b", "actor/w", "critic/b", "critic/w",
                               "layers/0/b", "layers/0/w", "layers/1/b",
                               "layers/1/w", "log_std"]
    # a trained-looking policy: the reference's params, perturbed
    rng = np.random.default_rng(0)
    p_np = jax.tree_util.tree_map(
        lambda x: np.asarray(x) + 0.3 * rng.normal(size=x.shape).astype(
            np.float32), jtree_np(p_j))
    p_j, p_t = jax.tree_util.tree_map(jnp.asarray, p_np), \
        convert.policy_params(p_np, DEV)

    tput = rng.uniform(0, 5e6, (3, 12)).astype(np.float32)
    backlog = np.where(rng.random((3, 12)) < 0.3, np.inf,
                       rng.uniform(0, 1e5, (3, 12))).astype(np.float32)
    ct = rng.uniform(-1, 20, (3, 7)).astype(np.float32)
    cg = rng.uniform(0, 50, (3, 7)).astype(np.float32)
    feat_j = np.stack([np_(j_pol.features(
        cfg, JObs(jnp.asarray(tput[b]), jnp.asarray(backlog[b])),
        jnp.asarray(ct[b]), jnp.asarray(cg[b]))) for b in range(3)])
    feat_t = t_pol.features(cfg, EnvObs(t_(tput), t_(backlog)), t_(ct),
                            t_(cg))
    np.testing.assert_allclose(np_(feat_t), feat_j, rtol=1e-6, atol=1e-6)
    f0_j = np_(j_pol.features(cfg, JObs(jnp.asarray(tput[0]),
                                        jnp.asarray(backlog[0]))))
    np.testing.assert_allclose(np_(t_pol.features(
        cfg, EnvObs(t_(tput[0]), t_(backlog[0])))), f0_j, rtol=1e-6,
        atol=1e-6)

    keys = jax.random.split(jax.random.PRNGKey(9), 3)
    n_act = t_pol.action_dim(cfg)
    noise = np.stack([np_(jax.random.normal(k, (n_act,))) for k in keys])
    out_t = t_pol.sample_action(cfg, p_t, t_(feat_j), noise=t_(noise))
    for b in range(3):
        out_j = j_pol.sample_action(cfg, p_j, jnp.asarray(feat_j[b]),
                                    keys[b])
        for got, want in zip(out_t, out_j):
            if want is None:
                assert got is None
                continue
            np.testing.assert_allclose(np_(got)[b], np_(want), rtol=1e-6,
                                       atol=1e-6)
        lp_j, ent_j, v_j = j_pol.logp_entropy(cfg, p_j,
                                              jnp.asarray(feat_j[b]),
                                              out_j[0])
        lp_t, ent_t, v_t = t_pol.logp_entropy(cfg, p_t, t_(feat_j[b]),
                                              t_(np_(out_j[0])))
        for got, want in ((lp_t, lp_j), (ent_t, ent_j), (v_t, v_j)):
            np.testing.assert_allclose(float(got), float(want), rtol=1e-6,
                                       atol=1e-6)
        for got, want in zip(t_pol.mean_action(cfg, p_t, t_(feat_j[b])),
                             j_pol.mean_action(cfg, p_j,
                                               jnp.asarray(feat_j[b]))):
            if want is not None:
                np.testing.assert_allclose(np_(got), np_(want), rtol=1e-6,
                                           atol=1e-6)


# --------------------------------------------------------- PPO contracts
def tiny_env(**kw):
    kw.setdefault("scenario", "dense_urban")
    kw.setdefault("scenario_overrides", dict(n_ues=8))
    for k, v in ENV.items():
        kw.setdefault(k, v)
    return TEnv(device="cpu", **kw)


def test_ppo_checkpoint_resume_is_bitwise(tmp_path):
    """4 uninterrupted iterations == 2 + save/restore + 2, bit for bit:
    every draw of an iteration is keyed on (seed, iteration, step), and
    the whole TrainState is the checkpoint."""
    env = tiny_env()
    pcfg, cfg = pcfg_of(env), t_ppo.PPOConfig(n_envs=2, n_steps=4)
    ts_a, hist_a = t_rl.train(env, pcfg, cfg, iterations=4, seed=0)
    assert all(np.isfinite(m["loss"]) for m in hist_a)
    d = str(tmp_path / "ckpt")
    t_rl.train(env, pcfg, cfg, iterations=2, seed=0, ckpt_dir=d,
               ckpt_every=1)
    ts_b, hist_b = t_rl.train(env, pcfg, cfg, iterations=4, seed=0,
                              ckpt_dir=d, ckpt_every=1)
    assert int(ts_b.iteration) == 4 and len(hist_b) == 2
    assert hist_b == hist_a[2:]
    keys_a, leaves_a = flatten(ts_a)
    keys_b, leaves_b = flatten(ts_b)
    assert keys_a == keys_b
    for k, a, b in zip(keys_a, leaves_a, leaves_b):
        assert a.dtype == b.dtype, k
        np.testing.assert_array_equal(np_(a), np_(b), err_msg=k)
    # another seed is another run
    ts_c, _ = t_rl.train(env, pcfg, cfg, iterations=1, seed=1)
    assert not torch.equal(ts_c.params["actor"]["w"],
                           t_rl.ppo_init(env, pcfg, cfg, 0).params
                           ["actor"]["w"])


def test_collect_requires_telemetry_and_a_fixed_topology():
    env = tiny_env(telemetry=False)
    with pytest.raises(ValueError, match="telemetry"):
        t_rl.make_collect_fn(env, pcfg_of(env), 4)
    env = tiny_env(resample_topology=True)
    with pytest.raises(ValueError, match="resample_topology"):
        t_rl.make_collect_fn(env, pcfg_of(env), 4)


def test_train_power_baseline_smoke(tmp_path):
    """The bench recipe end to end at micro shapes: eval selection,
    checkpointing and the result-dict contract of BENCH_rl.json."""
    kw = dict(n_ues=8, iterations=2, eval_every=1, n_envs=2, n_steps=2,
              tti_per_step=3, episode_tti=6, ckpt_dir=str(tmp_path / "ck"),
              device="cpu")
    out = t_ppo.train_power_baseline("dense_urban", **kw)
    assert len(out["history"]) == 2
    assert "uplift" in out["history"][-1]
    assert out["best_uplift"] >= out["final_uplift"] - 1e-9
    assert out["fixed_mbits"] > 0.0
    assert all(np.isfinite(m["loss"]) for m in out["history"])
    from repro_torch.train import checkpoint
    assert checkpoint.latest_step(str(tmp_path / "ck")) == 2
    out2 = t_ppo.train_power_baseline("dense_urban", **kw)
    assert out2["history"] == []          # nothing left to train
    assert out2["final_uplift"] == pytest.approx(out["final_uplift"])


def test_evaluate_uplift_compares_with_fixed_power():
    env = tiny_env()
    pcfg, cfg = pcfg_of(env), t_ppo.PPOConfig(n_envs=2, n_steps=2)
    ts = t_rl.ppo_init(env, pcfg, cfg, seed=0)
    uplift, learned, fixed = t_rl.evaluate_uplift(env, pcfg, ts.params, 1,
                                                  n_steps=2)
    assert learned > 0.0 and fixed > 0.0
    assert uplift == pytest.approx(learned / fixed)


# ---------------------------------------------------------------- diffopt
def test_diffopt_improves_soft_objective_and_matches_reference():
    ref, port = pair(make_scenario("dense_urban", n_ues=10))
    res = t_diffopt.optimize_power_plan(port, n_segments=2,
                                        tti_per_segment=4, steps=6, lr=0.3,
                                        score_every=0)
    assert res.u_plan.shape == (2, port.n_cells, port.params.n_subbands)
    soft = [h["soft_mbps"] for h in res.history]
    assert all(np.isfinite(soft))
    assert soft[-1] >= soft[0] - 1e-6, (
        f"gradient ascent went downhill: {soft[0]:.4f} -> {soft[-1]:.4f}")
    per_cell = np_(res.power_plan).sum(axis=-1)
    assert (per_cell <= port.params.power_W * (1 + 1e-5)).all()
    # u = 0 on the reference's draws: the reference's soft and hard values
    u0 = np.zeros((2, port.n_cells, port.params.n_subbands), np.float32)
    soft_j, hard_j = j_diffopt.make_power_objective(ref, tti_per_segment=4)
    soft_t, hard_t = t_diffopt.make_power_objective(
        port, tti_per_segment=4,
        draws=ReplayDraws(jax.random.PRNGKey(0), ref))
    with torch.no_grad():
        np.testing.assert_allclose(float(soft_t(t_(u0))),
                                   float(soft_j(jnp.asarray(u0))), rtol=1e-5)
    np.testing.assert_allclose(float(hard_t(t_(u0))),
                               float(hard_j(jnp.asarray(u0))), rtol=1e-5)
    np.testing.assert_allclose(
        np_(t_diffopt.plan_to_power(port.params, t_(u0 + 0.7))),
        np_(j_diffopt.plan_to_power(ref.params, jnp.asarray(u0 + 0.7))),
        rtol=1e-6)


def test_ppo_cli_runs_on_the_cpu(capsys):
    """``python -m repro_torch.rl.ppo`` end to end at micro shapes
    (``--smoke`` adds its assertions at 12 UEs x 45 iterations)."""
    assert t_ppo.main(["--n-ues", "8", "--iterations", "2",
                       "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "best uplift" in out and "iter 2/2" in out

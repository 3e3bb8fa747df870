"""The port's ``CrrmEnv`` on the ``outage_storm`` preset against the JAX
package's: reset and two steps with telemetry on the reference's draws,
and the port's autoreset under faults.  The engine's storm cases:
``tests/test_torch_faults_storm.py``; the shared contract:
``tests/test_torch_faults.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.env.crrm_env import CrrmEnv as JEnv
from repro.sim import scenarios as j_scen
from repro_torch.env.crrm_env import CrrmEnv as TEnv
from torch_parity import check_env_step, check_state, env_draws, port_of


def test_outage_storm_env_matches_reference():
    """``CrrmEnv(scenario="outage_storm")`` at 24 UEs x 6 cells with
    telemetry: reset and two steps (one with an action and a fairness
    override) on the reference's draws.  The reference cannot autoreset
    under faults (ROADMAP queue 3), so the port's ``step_autoreset`` is
    held to a fresh episode of its own: the fault leaf restarts all-UP."""
    params = j_scen.make_scenario("outage_storm", n_ues=24, n_cells=6)
    kw = dict(episode_tti=2, tti_per_step=1, telemetry=True)
    ref = JEnv(params=params, **kw)
    port = TEnv(sim=port_of(ref.sim), draws=env_draws(ref), **kw)
    sj, _ = ref.reset(jax.random.PRNGKey(3))
    st, _ = port.reset(3)
    check_state(st, sj)
    act = np.random.default_rng(0).uniform(
        0.0, port.max_cell_power_W, port.action_shape).astype(np.float32)
    with jax.disable_jit(True):
        out_j = ref.step(sj, ref.uniform_action())
        out_t = port.step(st, port.uniform_action())
        check_env_step(out_t, out_j)
        out_j = ref.step(out_j[0], jnp.asarray(act), jnp.float32(0.2))
        out_t = port.step(out_t[0], act, 0.2)
        check_env_step(out_t, out_j)
    assert bool(out_t[3]) and out_t[0].cell_state.shape == (6,)
    s_ar, *_ = port.step_autoreset(out_t[0], None, 7)
    fresh, _ = port.reset(7)
    assert torch.equal(s_ar.cell_state, torch.zeros(6, dtype=torch.int32))
    for a, b in zip(s_ar, fresh):
        assert b is None or torch.equal(a, b)

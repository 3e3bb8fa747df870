"""The port's TTI engine against the JAX package under mobility: the
``dense_urban_mobile`` handover trajectories, window movers with per-TTI
fading, the million-episode configuration in incremental mode (torch rows
and the fused route) and the incremental handover tables.  The cases and
contract of tests/test_torch_engine.py (its helpers too), in a file of
their own so that each file's reference compiles stay under a minute.
"""
import jax
import pytest

from repro.core.params import CRRM_parameters as JParams
from repro.sim import scenarios
from repro_torch.kernels import fused_sinr as t_fused
from test_torch_engine import BASE, MILLION, N_TTI, check
from torch_parity import ReplayDraws, carried, pair, run_pair


@pytest.mark.parametrize("per_tti_fading", [False, True])
def test_dense_urban_mobile_with_handover_matches_reference(per_tti_fading):
    """Mobility + A3 handover + per-RB fading (static or redrawn per TTI),
    rr so that the grants are exact integers."""
    params = scenarios.make_scenario("dense_urban_mobile", n_ues=40,
                                     n_cells=6, scheduler_policy="rr",
                                     traffic_model="full_buffer")
    check(*run_pair(params, per_tti_fading=per_tti_fading))


def test_window_movers_with_per_tti_fading_match_reference():
    params = JParams(**BASE, scheduler_policy="max_cqi",
                     rayleigh_fading=True, n_rb_subbands=2,
                     mobility_step_m=20.0, mobility_move_frac=0.25)
    check(*run_pair(params, per_tti_fading=True))


@pytest.mark.parametrize("inc_backend", ["torch", "fused"])
def test_million_episode_config_incremental_matches_reference(inc_backend):
    """The million-episode configuration at 64 UEs: incremental mode, the
    port's torch rows and its fused route (the kernel's plain version on
    the CPU) against the reference's incremental XLA rows."""
    params = JParams(n_ues=64, radio_mode="incremental", **MILLION)
    ref, port = run_pair(params, inc_backend="xla" if inc_backend == "torch"
                         else None)
    if inc_backend == "fused":
        # rerun the port through the fused route on the same inputs
        r, p = pair(params)
        k = jax.random.PRNGKey(0)
        _, _, static_t, state_t = carried(r, k)
        before = t_fused.fused_sinr_accumulate.launches
        port = p.episode_fns(inc_backend="fused").rollout(
            static_t, state_t, N_TTI, ReplayDraws(k, r))
        assert t_fused.fused_sinr_accumulate.launches == before  # CPU: plain
    check(ref, port)


def test_incremental_handover_tables_match_reference():
    """dense_urban_twin: incremental mode carrying the handover tables,
    through the torch row recompute."""
    params = scenarios.make_scenario("dense_urban_twin", n_ues=40, n_cells=6,
                                     scheduler_policy="rr",
                                     traffic_model="full_buffer")
    check(*run_pair(params, inc_backend="xla"))

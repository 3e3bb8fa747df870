"""The port's self-healing layer (``repro_torch.robust``) under the
``outage_storm`` faults, against the JAX package's: the ``outage_storm``
twin is held to the reference's (``test_torch_twin.serve_pair``) and
restores its fault codes bit for bit, and the chaos drill runs to
``CHAOS_OK``.  The guard and the watchdog: ``tests/test_torch_robust.py``,
whose storm settings these cases share.
"""
import torch

from repro.sim import scenarios as j_scen
from repro.sim.faults import FaultConfig as JFault
from repro_torch.robust import chaos
from repro_torch.sim.faults import FaultConfig as TFault
from test_torch_robust import STORM
from test_torch_twin import leaves_equal, serve_pair, twin_pair


# ------------------------------------------------ the storm and the drill
def test_fault_kpis_under_outage_storm_match_and_restore(tmp_path):
    """An ``outage_storm`` twin against the reference's (its KPIs carry
    ``mean_cells_down``/``reattach_events``), then a bitwise restore of the
    fault codes."""
    params = j_scen.make_scenario("outage_storm", n_ues=32, n_cells=6,
                                  faults=JFault(**STORM))
    ref, port = twin_pair(params, ckpt_dir=str(tmp_path / "sync"))
    assert port.faults == TFault(**STORM)
    full, flips = serve_pair(ref, port, tmp_path / "sync", n_chunks=2)
    assert full >= 1, flips
    port.ckpt_dir = str(tmp_path / "own")
    port.checkpoint()
    k2 = port.step_chunk()
    assert "mean_cells_down" in k2 and "reattach_events" in k2
    cs, state = port.state.cell_state.clone(), port.state
    assert port.restore() == 20
    assert port.step_chunk() == k2, "restored faulted twin diverged"
    assert torch.equal(port.state.cell_state, cs)
    leaves_equal(port.state, state)


def test_chaos_drill_smoke(capsys):
    chaos.main(["--smoke", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "CHAOS_OK" in out
    assert "survived injected NaN" in out
    assert "survived injected chunk crash" in out
    assert "survived corrupt latest checkpoint" in out

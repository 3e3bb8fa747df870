"""The port's profiling hooks, episode reports and roofline against the
reference's.

Exact: ``model_flops_episode``; the roofline's rows and table on one
artifact with the port's card constants patched to the reference's TPU
ones; ``StageTimer.report``'s row format on the same stage totals; the
kernels' ``work`` over the card's constants reproduces the bounds of
PERF.md (0.0102 ms at fused_sinr's ``main`` row, 0.3069 ms for the 1M x
127 D block).  The report runs on the CPU: the reference test's keys, 10
TTIs, no collective bytes on one device, and the radio rows it counts are
the rows the engine recomputes.  The collective counter's ring cost is
held to a hand count on 2 gloo ranks.
"""
import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro.analysis import roofline as j_roofline
from repro.obs import profile as j_profile
from repro.obs import report as j_report
from repro_torch.analysis import roofline
from repro_torch.core import distributed as D
from repro_torch.core.crrm import CRRM
from repro_torch.kernels import fused_sinr as fk
from repro_torch.kernels import pairwise_dist as pdk
from repro_torch.mac.engine import Draws
from repro_torch.obs import StageTimer, annotate, profile, report, trace
from repro_torch.sim import pathloss
from repro_torch.sim import scenarios as t_scenarios
from torch_mesh import one_rank_group, run_ranks

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("n_ues,n_cells,n_freq,n_tti", [
    (24, 6, 1, 10), (200, 21, 4, 20), (1_000_000, 127, 1, 5),
    (4_194_304, 65_536, 2, 1), (7, 3, 6, 0)])
def test_model_flops_episode_equals_the_reference(n_ues, n_cells, n_freq,
                                                  n_tti):
    assert report.model_flops_episode(n_ues, n_cells, n_freq, n_tti) == \
        j_report.model_flops_episode(n_ues, n_cells, n_freq, n_tti)


ARTIFACTS = {
    "analytic": dict(n_devices=1, analytic_flops=3.2e12,
                     analytic_bytes=7.5e9, hlo_flops=1.0, hlo_bytes=1.0,
                     collective_wire_bytes=0.0, model_flops=1.6e12),
    "hlo": dict(n_devices=4, hlo_flops=8.1e11, hlo_bytes=2.4e11,
                collective_wire_bytes=3.3e9, model_flops=9.0e11),
    "broken": dict(skipped=True, reason="no cost analysis"),
}


@pytest.fixture
def reference_constants(monkeypatch):
    for name in ("PEAK_FLOPS", "HBM_BW", "ICI_BW"):
        monkeypatch.setattr(roofline, name, getattr(j_roofline, name))


def test_roofline_strings_equal_the_reference(reference_constants):
    for name, art in ARTIFACTS.items():
        if not art.get("skipped"):
            assert roofline.format_row(name, art) == \
                j_roofline.format_row(name, art)
            assert dataclasses.asdict(roofline.from_artifact(art)) == \
                dataclasses.asdict(j_roofline.from_artifact(art))
    table = report.roofline_table(ARTIFACTS)
    assert table == j_report.roofline_table(ARTIFACTS)
    assert "| broken | - | - | - | skipped: no cost analysis | - | - |" \
        in table


def test_roofline_constants_are_the_h100s():
    assert (roofline.PEAK_FLOPS, roofline.HBM_BW, roofline.ICI_BW) == \
        (67e12, 3.35e12, 450e9)
    r = roofline.from_artifact(ARTIFACTS["analytic"])
    assert r.dominant == "compute"
    assert r.compute_s == pytest.approx(3.2e12 / 67e12, rel=1e-15)


def test_write_report_writes_the_table_and_the_artifacts(tmp_path):
    table = report.write_report(str(tmp_path), ARTIFACTS)
    assert (tmp_path / "roofline.md").read_text().endswith(table + "\n")
    for name, art in ARTIFACTS.items():
        assert json.loads((tmp_path / f"{name}.json").read_text()) == art


def test_stage_timer_rows_have_the_reference_format():
    port, ref = StageTimer(), j_profile.StageTimer()
    for t in (port, ref):
        t._total.update(rollout=0.4125, prepare=0.0311, sync=0.00042)
        t._calls.update(rollout=3, prepare=1, sync=12)
    assert port.report("  # ") == ref.report("  # ")
    assert StageTimer().report() == j_profile.StageTimer().report()


def test_stage_timer_times_and_counts_stages():
    timer = StageTimer()
    out = timer.time("add", lambda x: (x + 1, {"y": x * 2}), torch.ones(3))
    assert torch.equal(out[0], torch.full((3,), 2.0))
    with timer.stage("add"):
        pass
    assert timer._calls == {"add": 2} and timer.total_s("add") > 0.0
    assert timer.total_s("missing") == 0.0


def test_trace_writes_a_chrome_trace_with_the_spans(tmp_path):
    with trace(str(tmp_path)) as prof:
        with annotate("prepare"):
            x = torch.arange(1000.0)
        with annotate("rollout"):
            (x * x).sum()
    events = json.loads((tmp_path / profile.TRACE_FILE).read_text())
    names = {e.get("name") for e in events["traceEvents"]}
    assert {"prepare", "rollout"} <= names
    assert any(e.key == "rollout" for e in prof.key_averages())
    assert profile.kernel_times(prof) == {}      # no device on the CPU


def test_kernel_work_gives_the_bounds_of_perf_md():
    def bound_ms(ops, nbytes):
        return max(ops / roofline.PEAK_FLOPS, nbytes / roofline.HBM_BW) * 1e3
    uma = pathloss.UMa_pathloss().kernel_spec()[0]
    ops, nbytes = fk.work(100_000, 127, 1, 0, uma, 1)
    assert ops / roofline.PEAK_FLOPS > nbytes / roofline.HBM_BW  # operations
    assert f"{bound_ms(ops, nbytes):.4f}" == "0.0102"
    ops, nbytes = pdk.work(1_000_000, 127)
    assert nbytes / roofline.HBM_BW > ops / roofline.PEAK_FLOPS  # bytes
    assert f"{bound_ms(ops, nbytes):.4f}" == "0.3069"
    # the row read by index, the sectors and the fading add to the count
    ops3, b3 = fk.work(10, 4, 2, 80, uma, 3, idx_bytes=40)
    assert ops3 == 10 * 4 * (11 + 36 + 2 * 6 + 1 + 12)
    assert b3 == 4 * (30 + 12 + 8 + 4) + 4 * 80 + 40 + 4 * (40 + 20)


REPORT_KEYS = ("n_devices", "model_flops", "n_ues", "backend")


def test_episode_report_artifact_on_the_cpu(tmp_path):
    sim = CRRM(t_scenarios.make_scenario("dense_urban", n_ues=24,
                                         n_cells=6), device="cpu")
    art = report.episode_report(sim, 10, scenario="dense_urban")
    for key in REPORT_KEYS:
        assert key in art, key
    assert art["n_tti"] == 10 and art["backend"] == "cpu"
    assert art["collective_wire_bytes"] == 0.0
    assert art["analytic_flops"] > 0 and art["analytic_bytes"] > 0
    assert art["wall_ms_per_tti"] > 0
    assert art["device_ms_per_tti"] is None          # no device measured
    assert art["kernel_launches"] == {"fused_sinr": 0, "pairwise_dist": 0}
    assert art["model_flops"] == j_report.model_flops_episode(
        sim.n_ues, sim.n_cells, sim.params.n_freq, 10)
    table = report.write_report(str(tmp_path), {"dense_urban": art})
    assert "| dense_urban |" in table
    assert json.loads((tmp_path / "dense_urban.json").read_text())[
        "n_tti"] == 10


def test_report_counts_the_rows_the_engine_recomputes():
    """Incremental with window movers: the rows per TTI the report counts
    are the telemetry's dirty rows; the totals are the written terms."""
    sim = CRRM(t_scenarios.make_scenario("dense_urban_twin", n_ues=50),
               device="cpu")
    static, state = sim.episode_static(), sim.init_episode_state()
    counts = report.analytic_counts(sim, static, state, 4)
    _, _, telem = sim.episode_fns(telemetry=True).rollout(
        static, state, 4, Draws(0, "cpu"))
    assert counts["rows_init"] == 50 and counts["rows_per_tti"] == 5
    assert telem.dirty_rows.tolist() == [5] * 4
    k, f = static.P.shape[1], sim.params.n_freq
    model = sim.radio_config().pathgain_fn.kernel_spec()[0]
    fad_row = static.fad[0].numel()
    init_ops, init_bytes = fk.work(50, sim.n_cells, k, 50 * fad_row, model,
                                   sim.params.n_sectors)
    ops, nbytes = fk.work(5, sim.n_cells, k, 5 * fad_row, model,
                          sim.params.n_sectors, idx_bytes=20)
    rest = report.REST_OPS_PER_UE_FREQ * 50 * f + report.REST_OPS_PER_UE * 50
    assert counts["flops"] == init_ops + 4 * (ops + rest)
    # the fading tensor is read only as the radio rows read it
    leaves = [x for x in list(static._replace(fad=None)) + 2 * list(
        state._replace(fad=None)) if isinstance(x, torch.Tensor)]
    assert counts["rest_bytes_per_tti"] == sum(
        x.numel() * x.element_size() for x in leaves) + 4 * 50
    assert counts["bytes"] == init_bytes + 4 * (
        nbytes + counts["rest_bytes_per_tti"])
    # a static field recomputes no radio row
    still = CRRM(t_scenarios.make_scenario("dense_urban", n_ues=8),
                 device="cpu")
    assert report.radio_rows(still.params, 8) == (0, 0)


def test_report_cli_writes_artifacts(tmp_path):
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.obs.report", "--scenario",
         "dense_urban", "--n-ues", "16", "--n-tti", "5", "--device", "cpu",
         "--out", str(tmp_path)],
        capture_output=True, text=True, timeout=300, cwd=REPO,
        env={**os.environ, "PYTHONPATH": "src"})
    assert out.returncode == 0, out.stdout + "\n" + out.stderr
    assert (tmp_path / "roofline.md").exists()
    assert "| dense_urban |" in out.stdout
    art = json.loads((tmp_path / "dense_urban.json").read_text())
    assert art["n_ues"] == 16 and art["n_tti"] == 5


def test_one_rank_group_counts_calls_and_no_wire_bytes(tmp_path):
    with one_rank_group(tmp_path):
        mesh = D.make_mesh((1,), ("data",), "cpu")
        with D.count_collectives() as c:
            D.psum(torch.ones(100, 3), mesh.axes("data"))
    assert c.counts == {"all-reduce": 1}
    assert c.total_wire_bytes == 0.0


def test_two_ranks_count_the_ring_cost(tmp_path):
    """psum of a (100, 3) float32 and pmax of a (7,) int32 over 2 gloo
    ranks: 2 * B * (n - 1) / n wire bytes each, by hand 1200 + 28."""
    outs = run_ranks(dict(name="collectives"), 2, tmp_path)
    for out in outs:
        assert out["counts"] == {"all-reduce": 2}
        assert out["bytes_by_kind"] == {"all-reduce": 1228.0}
        assert out["total_wire_bytes"] == 2 * 1200 * 1 / 2 + 2 * 28 * 1 / 2
        np.testing.assert_array_equal(out["sum"], np.full((100, 3), 2.0))
        assert out["process"] == out["total_wire_bytes"]

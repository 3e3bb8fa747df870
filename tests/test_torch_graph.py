"""The port's smart-update graph and ``CRRM`` API against the JAX package.

The same mutate/query sequence on both simulators (built on the same
roots): every query's output to the contract (gains/RSRP rtol 1e-5,
SINR rtol 1e-4 times its condition number, attachment exact with no near
ties at these seeds, CQI/MCS/SE exact away from CQI steps, throughputs
rtol 1e-4 away from CQI steps), and ``update_counts()`` -- which node
recomputed in full and which patched rows -- equal to the reference's.
"""
import jax
import numpy as np
import pytest
import torch

from repro.core.crrm import CRRM as JCRRM
from repro.core.params import CRRM_parameters as JParams
from repro.sim import scenarios
from repro_torch.core import graph as t_graph
from repro_torch.core.crrm import CRRM as TCRRM
from repro_torch.core.params import CRRM_parameters as TParams
from torch_parity import (assert_attachment, assert_cqi, assert_sinr, np_,
                          pair, near_threshold)

RTOL_GAIN = 1e-5
RTOL_TPUT = 1e-4   # sum order of the per-cell shares


def meas_of(sim):
    """The reference's attachment measurement (faded or long-term)."""
    node = getattr(sim, "R_mean", sim.R)
    return np_(node.update()).sum(axis=2)


def compare(ref, port):
    cfg = ref.radio_config()
    np.testing.assert_allclose(np_(port.get_pathgains()),
                               np_(ref.get_pathgains()), rtol=RTOL_GAIN)
    np.testing.assert_allclose(np_(port.get_RSRP()), np_(ref.get_RSRP()),
                               rtol=RTOL_GAIN)
    for x, y in zip(port.get_distances()[:2], ref.get_distances()[:2]):
        np.testing.assert_allclose(np_(x), np_(y), rtol=1e-6)
    assert_attachment(port.get_attachment(), ref.get_attachment(),
                      meas_of(ref))
    assert_sinr(port.get_SINR(), ref.get_SINR(), ref.w.update(),
                ref.u.update(), cfg.noise_w)
    g = ref.get_SINR()
    for q in ("get_CQI", "get_MCS", "get_spectral_efficiency"):
        assert_cqi(getattr(port, q)(), getattr(ref, q)(), g)
    # per-UE throughputs share cells: any UE on a CQI step moves its cell
    edge = near_threshold(g).any(axis=1)
    a = np_(ref.get_attachment())
    clean = ~np.isin(a, a[edge])
    for q in ("get_UE_throughputs", "get_served_throughputs"):
        np.testing.assert_allclose(np_(getattr(port, q)())[clean],
                                   np_(getattr(ref, q)())[clean],
                                   rtol=RTOL_TPUT)
    np.testing.assert_allclose(np_(port.get_shannon_capacities()),
                               np_(ref.get_shannon_capacities()), rtol=1e-4)
    np.testing.assert_array_equal(np_(port.get_backlog()),
                                  np_(ref.get_backlog()))
    assert port.update_counts() == ref.update_counts()


@pytest.mark.parametrize("name,smart", [
    ("dense_urban", True), ("rural_macro", True), ("indoor_hotspot", True),
    ("handover_stress", True), ("dense_urban", False)])
def test_mutate_query_sequence_matches_reference(name, smart):
    ref, port = pair(scenarios.make_scenario(name, n_ues=40, n_cells=6,
                                             smart=smart))
    compare(ref, port)
    for sim in (ref, port):
        sim.move_UE(3, (100.0, 200.0, 1.5))
        sim.move_UEs([5, 9, 5], np.array([[300.0, 40.0, 1.5],
                                          [20.0, 20.0, 1.5],
                                          [310.0, 45.0, 1.5]], np.float32))
    compare(ref, port)
    for sim in (ref, port):
        sim.add_traffic([1, 2, 2], [1000.0, 500.0, 250.0])
    compare(ref, port)
    P = np_(ref.P._data).copy()
    P[1] *= 0.5
    for sim in (ref, port):
        sim.set_power_matrix(P)
        sim.set_cell_power(0, 0, 2.0)
    compare(ref, port)
    for sim in (ref, port):
        sim.move_UE(0, (50.0, 60.0, 1.5))
        sim.set_backlog(np.full(40, 1e5, np.float32))
    compare(ref, port)


@pytest.mark.parametrize("policy", ["rr", "max_cqi", "pf"])
def test_schedule_matches_reference(policy):
    """The ScheduleNode grid: exact RB counts for rr/max_cqi, rtol for pf."""
    ref, port = pair(JParams(n_ues=60, n_cells=7, seed=4, power_W=10.0,
                             scheduler_policy=policy, fairness_p=0.5,
                             n_rb_subbands=3, rayleigh_fading=True))
    cqi_edge = near_threshold(ref.get_SINR())
    assert not cqi_edge.any()
    a = np_(ref.get_schedule())
    b = np_(port.get_schedule())
    if policy == "pf":
        np.testing.assert_allclose(b, a, rtol=1e-4, atol=1e-5)
    else:
        np.testing.assert_array_equal(b, a)
    assert port.update_counts() == ref.update_counts()


def test_pad_indices_bucket_and_graph_flood_semantics():
    g = t_graph.Graph()
    U = g.add(t_graph.RootNode("U", torch.zeros(8, 2)))

    class Double(t_graph.Node):
        supports_row_update = True

        def __init__(self):
            super().__init__("x2")
            self.watch(U)

        def update_data(self):
            return U._data * 2

        def update_rows(self, idx):
            self._data[idx] = U._data[idx] * 2
            return self._data

    n = g.add(Double())
    n.update()
    held = U._data
    U.set_rows([1, 5], torch.ones(2, 2))
    assert n.dirty_rows == {1, 5}
    assert float(n.update().sum()) == 8.0
    assert float(held.sum()) == 0.0     # root writes never alias readers
    assert g.stats()["x2"] == (1, 1)
    U.set(torch.ones(8, 2))
    n.update()
    assert g.stats()["x2"] == (2, 1)
    with pytest.raises(RuntimeError, match="never set"):
        t_graph.RootNode("empty").update()


def test_crrm_default_drop_is_seeded_and_in_region():
    a = TCRRM(TParams(n_ues=50, seed=3, rayleigh_fading=True), device="cpu")
    b = TCRRM(TParams(n_ues=50, seed=3, rayleigh_fading=True), device="cpu")
    assert torch.equal(a.U._data, b.U._data)
    assert torch.equal(a.fading._data, b.fading._data)
    U = a.U._data
    assert (U[:, :2] >= 0).all() and (U[:, :2] <= 3000.0).all()
    assert (U[:, 2] == 1.5).all()
    # the default hex grid is the reference's
    j = JCRRM(JParams(n_ues=5, n_cells=19, n_sectors=1))
    t = TCRRM(TParams(n_ues=5, n_cells=19, n_sectors=1), device="cpu")
    np.testing.assert_allclose(np_(t.C._data), np_(j.C._data), rtol=1e-6)
    np.testing.assert_allclose(np_(t.boresight._data),
                               np_(j.boresight._data), rtol=1e-7)


def test_later_slices_raise_not_implemented():
    sim = TCRRM(TParams(n_ues=8, n_cells=3), device="cpu")
    # churn, faults, relax and the mesh are ported
    # (tests/test_torch_{churn,faults,relax,mesh_engine}.py): a mesh must
    # be a core.distributed.Mesh, and cell_axis needs one
    with pytest.raises(TypeError, match="Mesh"):
        sim.episode_fns(mesh=object())
    with pytest.raises(ValueError, match="requires mesh"):
        sim.episode_fns(cell_axis="c")
    from repro_torch.sim.radio import RelaxConfig
    assert sim.episode_fns(relax=RelaxConfig()).rollout is not None

"""The port's engine on a UE x cell mesh (``episode_fns(mesh=,
cell_axis=)``) against its single device.

As ``tests/test_smart_update_scan.py``'s UE x cell script: a (1, 2) mesh
(cells sharded over 2 gloo ranks, ``tests/torch_mesh.py``), every registry
scenario at 24 UEs x 6 cells in incremental mode and ``dense_urban``
dense (also under a power action, whose cell columns each shard takes),
8 TTIs of window movers, on the reference's recorded draws.  The
cell-sharded chain sums the interference total over the shards, which
reorders a float sum: throughput rtol 1e-5 (atol 1e-2), every state leaf
rtol 1e-5 (atol 1e-3); attachment (through the serving cell), positions,
fault codes and the TTI counter exact.  Every rank returns the same bits.
"""
import numpy as np
import pytest

from repro.sim import scenarios
from test_torch_mesh_engine import CELL_MESH, assert_same_values, case_of
from torch_mesh import run_ranks, same_on_every_rank
from torch_parity import np_, pair

CELL_CASES = [(n, "incremental") for n in scenarios.scenario_names()] + [
    ("dense_urban", "dense"), ("dense_urban", "dense+action")]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    cases, singles = {}, {}
    for name, mode in CELL_CASES:
        ref, port = pair(scenarios.make_scenario(name, n_ues=24, n_cells=6))
        key = f"{name}/{mode}"
        # a power action: each cell's block of the (n_cells, n_freq) plan
        action = None
        if mode.endswith("+action"):
            P = np_(port.episode_static().P)
            action = (P * np.random.default_rng(5).uniform(
                0.2, 1.0, (P.shape[0], 1))).astype(np.float32)
        cases[key], _, singles[key] = case_of(
            ref, port, dict(radio_mode=mode.removesuffix("+action"),
                            mobility_step_m=20.0, mobility_move_frac=0.25),
            8, CELL_MESH, action)
    outs = run_ranks(dict(name="rollouts", cases=cases), 2,
                     tmp_path_factory.mktemp("mesh_cells"))
    return outs, singles


@pytest.mark.parametrize("name,mode", CELL_CASES)
def test_ue_cell_mesh_matches_single_device(runs, name, mode):
    outs, singles = runs
    key = f"{name}/{mode}"
    s_m, t_m, tel_m, backend = outs[0][key]
    s_1, t_1, tel_1 = singles[key]
    assert backend == ("torch" if mode == "incremental" else None)
    if mode.endswith("+action"):      # the action reached the chain
        assert not np.allclose(t_m, outs[0][f"{name}/dense"][1])
    np.testing.assert_allclose(t_m, np_(t_1), rtol=1e-5, atol=1e-2)
    for f in ("U", "serving", "cell_state", "t"):
        assert_same_values(getattr(s_m, f), getattr(s_1, f), f)
    for f, got in s_m._asdict().items():
        if got is not None and f != "seed":
            np.testing.assert_allclose(got, np_(getattr(s_1, f)), rtol=1e-5,
                                       atol=1e-3, err_msg=f)
    for f in ("harq_acks", "harq_nacks", "ho_events", "dirty_rows",
              "cells_down", "reattach_events"):
        assert_same_values(getattr(tel_m, f), getattr(tel_1, f), f)


def test_every_rank_returns_the_same_bits(runs):
    same_on_every_rank(runs[0])

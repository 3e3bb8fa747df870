"""The port's crrm-ppp dry-run cells against the reference's.

``configs.crrm_ppp.SHAPES`` is the reference's.  The analytic flops and
bytes of each of the three cells equal what the reference's
``run_crrm_cell`` writes when it lowers the cell on a 1-device ``("data",
"model")`` mesh (it lowers without allocating, so at the cells' own
shapes).  ``run_crrm_cell`` runs a small cell of each variant on the CPU
(a 1-rank gloo group) and its outputs are held to the reference's
``make_*_step`` on the same numpy field, at the tolerances of
``tests/test_torch_mesh_cells.py``: attachment exact, throughput rtol
1e-5 (atol 1e-2 bit/s), every float state rtol 1e-5 (with no absolute
floor: the powers are ~1e-9 W; the interference u = total - w to 1e-5 of
the total), and the
SINR rtol 1e-5 times the condition number of w / (noise + total - w), as
``chip_smoke.py`` holds the step makers on the card.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from repro.configs import crrm_ppp as j_crrm_ppp
from repro.core import distributed as j_dist
from repro.sim.pathloss import make_pathloss as j_make_pathloss
from repro_torch.configs import ARCH_IDS, LM_ARCH_IDS, crrm_ppp
from repro_torch.core import distributed as D
from repro_torch.launch import dryrun
from torch_mesh import one_rank_group

SMALL = {
    "net_256k": dict(n_ues=512, n_cells=64, n_subbands=2,
                     variant="materialized"),
    "net_4m": dict(n_ues=2048, n_cells=1024, n_subbands=2,
                   variant="streaming"),
    "net_4m_inc": dict(n_ues=2048, n_cells=1024, n_subbands=2,
                       variant="incremental", max_moves=32),
}


@pytest.fixture(scope="module")
def reference_dryrun():
    """``repro.launch.dryrun``, whose import sets ``XLA_FLAGS`` for a
    forced host device count: the variable is put back as it was (JAX's
    CPU backend is already up, so the import cannot resize it)."""
    with pytest.MonkeyPatch.context() as mp:
        import os
        mp.setenv("XLA_FLAGS", os.environ.get("XLA_FLAGS", ""))
        import repro.launch.dryrun as rd
    return rd


def one_device_mesh():
    return Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("data", "model"))


def test_shapes_and_arch_ids_are_the_reference_s():
    assert crrm_ppp.SHAPES == j_crrm_ppp.SHAPES
    assert crrm_ppp.ARCH_ID == j_crrm_ppp.ARCH_ID
    from repro.configs import ARCH_IDS as J_ARCH_IDS
    from repro.configs import LM_ARCH_IDS as J_LM_ARCH_IDS
    assert ARCH_IDS == J_ARCH_IDS and LM_ARCH_IDS == J_LM_ARCH_IDS
    assert "crrm-ppp" in ARCH_IDS and "crrm-ppp" not in LM_ARCH_IDS


@pytest.mark.parametrize("shape", sorted(j_crrm_ppp.SHAPES))
def test_analytic_counts_equal_what_the_reference_writes(reference_dryrun,
                                                         shape, tmp_path):
    art = reference_dryrun.run_crrm_cell(shape, one_device_mesh(), "one",
                                         str(tmp_path), force=True)
    assert "failed" not in art, art.get("error")
    assert dryrun.analytic_counts(crrm_ppp.SHAPES[shape]) == (
        art["analytic_flops"], art["analytic_bytes"])
    assert art["model_flops"] == art["analytic_flops"]


def reference_outputs(sh, field):
    """The reference's step of the cell's variant on ``field``."""
    M, K = sh["n_cells"], sh["n_subbands"]
    common = dict(mesh=one_device_mesh(),
                  pathgain_fn=j_make_pathloss(
                      "power_law", alpha=dryrun.ALPHA).get_pathgain,
                  noise_w=dryrun.NOISE_W, n_cells=M,
                  subband_bw=dryrun.BANDWIDTH_HZ / K, fairness_p=0.0,
                  ue_axis=("data",), cell_axis=("model",))
    U, C, Pw = (jnp.asarray(field[k]) for k in ("U", "C", "Pw"))
    if sh["variant"] == "materialized":
        return jax.jit(j_dist.make_materialized_step(**common))(U, C, Pw)
    if sh["variant"] == "streaming":
        return jax.jit(j_dist.make_streaming_step(**common))(U, C, Pw)
    step = jax.jit(j_dist.make_incremental_rows_step(**common))
    n = U.shape[0]
    _, w, u, a, bv, _ = step(U, C, Pw, jnp.zeros((n, K)), jnp.zeros((n, K)),
                             jnp.zeros((n,), jnp.int32),
                             jnp.full((n,), -jnp.inf),
                             jnp.arange(n, dtype=jnp.int32), U)
    return step(U, C, Pw, w, u, a, bv, jnp.asarray(field["idx"]),
                jnp.asarray(field["new_pos"]))


def float64_w_u(field):
    """The serving and interference power of every UE in float64: what
    the condition number of its SINR is reckoned from."""
    U, C = field["U"].astype(np.float64), field["C"].astype(np.float64)
    d3d = np.sqrt(((U[:, None, :] - C[None, :, :]) ** 2).sum(axis=2))
    r = (np.maximum(d3d, 1e-9) ** -dryrun.ALPHA)[:, :, None] * field["Pw"]
    w = np.take_along_axis(r, r.sum(axis=2).argmax(axis=1)[:, None, None],
                           axis=1)[:, 0]
    return w, r.sum(axis=1) - w


def assert_sinr_within_kappa(gamma, want, field):
    w, u = float64_w_u(field)
    kappa = 1.0 + (2 * w + u) / (dryrun.NOISE_W + u)
    err = np.abs(gamma.astype(np.float64) - want)
    assert np.all(err <= 1e-5 * kappa * np.abs(want)), \
        f"SINR off by {np.max(err / (kappa * np.abs(want))):.2e} x kappa"


@pytest.mark.parametrize("shape", sorted(SMALL))
def test_small_cell_matches_the_reference_steps(shape, tmp_path,
                                                monkeypatch):
    sh = SMALL[shape]
    monkeypatch.setitem(crrm_ppp.SHAPES, shape, sh)
    with one_rank_group(tmp_path):
        mesh = D.make_mesh((1, 1), ("data", "model"), "cpu")
        art, out = dryrun.run_crrm_cell(shape, mesh, "cpu-1x1",
                                        str(tmp_path / "art"), seed=3)
    out = tuple(x.numpy() for x in out)
    field = dryrun.cell_field(sh, 3)
    assert art["n_devices"] == 1 and art["collective_wire_bytes"] == 0.0
    assert art["collective_counts"]["all-reduce"] > 0
    assert (art["analytic_flops"], art["analytic_bytes"]) == \
        dryrun.analytic_counts(sh)
    assert art["reduced"] == [] and art["device_ms"] is None
    assert art["roofline_row"].startswith(f"| cpu-1x1/crrm-ppp/{shape} |")
    saved = json.loads((tmp_path / "art" / "cpu-1x1" / "crrm-ppp" /
                        f"{shape}.json").read_text())
    assert saved["roofline_row"] == art["roofline_row"]
    if sh["variant"] != "incremental":
        gamma, a, tput = out
        g_j, a_j, t_j = reference_outputs(sh, field)
        np.testing.assert_array_equal(a, np.asarray(a_j))
        assert_sinr_within_kappa(gamma, np.asarray(g_j, np.float64), field)
        np.testing.assert_allclose(tput, np.asarray(t_j), rtol=1e-5,
                                   atol=1e-2)
        return
    U_j, w_j, u_j, a_j, bv_j, t_j = reference_outputs(sh, field)
    U2, w2, u2, a2, bv2, t2 = out
    np.testing.assert_array_equal(U2, np.asarray(U_j))
    np.testing.assert_array_equal(a2, np.asarray(a_j))
    # powers are ~1e-9 W: no absolute floor; u = total - w is held to
    # 1e-5 of the total it is the difference of
    for got, want in ((w2, w_j), (bv2, bv_j)):
        np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5)
    w_j, u_j = np.asarray(w_j, np.float64), np.asarray(u_j, np.float64)
    assert np.all(np.abs(u2 - u_j) <= 1e-5 * (w_j + u_j))
    np.testing.assert_allclose(t2, np.asarray(t_j), rtol=1e-5, atol=1e-2)
    assert art["setup"]["wall_ms"] > 0


def test_plan_fits_the_cells_to_one_card():
    budget = 0.9 * 80e9
    sh = crrm_ppp.SHAPES
    plan = dryrun.plan_cell(sh["net_256k"], budget)
    assert "cell_tile" not in plan and plan["reduced"] == []
    # (N, M) planes of 4.29 GB: seven at the geometry's peak
    assert plan["reckoned_bytes"] == 4 * (7 * 262_144 * 4096 + 54 * 262_144
                                          + 5 * 4096)
    plan = dryrun.plan_cell(sh["net_4m"], budget)
    assert plan["cell_tile"] == 256
    assert len(plan["reduced"]) == 1 and "512 -> 256" in plan["reduced"][0]
    assert plan["reckoned_bytes"] <= budget < dryrun.reckon_bytes(
        "streaming", 4_194_304, 4_194_304, 65_536, 2, 512)
    plan = dryrun.plan_cell(sh["net_4m_inc"], budget)
    assert (plan["setup_tile"], plan["cell_tile"]) == (256, 512)
    assert "set-up" in plan["reduced"][0] and len(plan["reduced"]) == 1


def test_a_cell_that_cannot_fit_raises_with_its_bytes():
    with pytest.raises(MemoryError, match=r"needs 30\.12 GB reckoned"):
        dryrun.plan_cell(crrm_ppp.SHAPES["net_256k"], 20e9)
    with pytest.raises(MemoryError, match="cell tile of 1"):
        dryrun.plan_cell(crrm_ppp.SHAPES["net_4m"], 1e9)


def test_cli_runs_a_cell_and_keeps_its_artifact(tmp_path, monkeypatch,
                                                capsys):
    monkeypatch.setitem(crrm_ppp.SHAPES, "net_256k", SMALL["net_256k"])
    argv = ["--arch", "crrm-ppp", "--shape", "net_256k", "--device", "cpu",
            "--out", str(tmp_path)]
    dryrun.main(argv)
    path = tmp_path / "cpu-1x1" / "crrm-ppp" / "net_256k.json"
    first = json.loads(path.read_text())
    assert first["n_ues"] == 512 and first["variant"] == "materialized"
    dryrun.main(argv)                    # kept: not run again
    assert json.loads(path.read_text()) == first
    dryrun.main(argv + ["--force"])
    assert json.loads(path.read_text())["wall_ms"] != first["wall_ms"]
    assert "| cpu-1x1/crrm-ppp/net_256k |" in capsys.readouterr().out
    assert torch.distributed.is_initialized() is False

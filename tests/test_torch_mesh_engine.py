"""The port's sharded TTI engine (``episode_fns(mesh=)``) against one device.

Three references for a mesh rollout, all from the same carried state and
on the reference's draws (``torch_parity.ReplayDraws``, recorded in the
pytest process and replayed in the ranks by ``torch_mesh.RecordedDraws``):

* the reference's single-device rollout, under the engine parity contract
  of tests/test_torch_engine.py (throughput rtol 1e-4, integer state exact,
  telemetry through ``torch_parity.check_telemetry``); bursty traffic rolls
  the reference out eagerly, as there;
* the port's own single-device rollout: bitwise for rr and max_cqi (their
  cross-shard reductions are integer-exact), and for pf at full buffer
  within 1e-5 in ``BENCH_sharded``'s measure, max |difference| /
  max(max |throughput|, 1), with attachment, serving cell and positions
  exact (its cross-shard sum reorders a float reduction; under bursty
  traffic an ulp residue could flip a backlog-active mask, so pf is held
  at full buffer only);
* on a trivial 1-rank mesh in this process, the plain rollout bit for bit.

The UE mesh runs 2 gloo ranks (``tests/torch_mesh.py``) on the cases of
``tests/test_radio_fns.py``'s sharded script, and every rank returns the
same bits.  The incremental cases (tests/test_torch_mesh_incremental.py)
and the UE x cell mesh (tests/test_torch_mesh_cells.py) have files of
their own, so that each file's eager reference runs and spawns stay under
a minute.
"""
from concurrent.futures import ThreadPoolExecutor

import jax
import numpy as np
import pytest
import torch

from repro.core.params import CRRM_parameters as JParams
from repro_torch.core.crrm import CRRM as TCRRM
from repro_torch.core.distributed import make_mesh
from repro_torch.core.params import CRRM_parameters as TParams
from repro_torch.mac.engine import Draws
from repro_torch.sim.mobility import ChurnConfig
from repro_torch.sim.radio import RelaxConfig
from torch_mesh import Recorder, one_rank_group, run_ranks, same_on_every_rank
from torch_parity import (RTOL_TPUT, ReplayDraws, carried, check_state,
                          check_telemetry, fields_of, np_, pair)

N_TTI = 20
BASE = dict(n_ues=64, n_cells=7, seed=3, pathloss_model_name="UMa",
            power_W=10.0)
PO = dict(traffic_model="poisson",
          traffic_params=dict(arrival_rate_hz=300.0,
                              packet_size_bits=12_000.0))
#: name: (policy exact across shards?, episode_fns keywords, params)
UE_CASES = {
    "rr_poisson_harq": (True, {}, dict(scheduler_policy="rr", harq_bler=0.3,
                                       **PO)),
    "max_cqi_selective": (True, dict(per_tti_fading=True),
                          dict(scheduler_policy="max_cqi",
                               rayleigh_fading=True, n_rb_subbands=4)),
    "ho_mobility_rr": (True, {}, dict(scheduler_policy="rr", ho_enabled=True,
                                      rayleigh_fading=True,
                                      mobility_step_m=20.0, **PO)),
    "pf_full_buffer_fading": (False, dict(per_tti_fading=True),
                              dict(scheduler_policy="pf", fairness_p=0.5,
                                   rayleigh_fading=True)),
}
UE_MESH = ((2,), ("ue",), {})
CELL_MESH = ((1, 2), ("ue", "cell"), dict(cell_axis=("cell",)))


def case_of(ref, port, fns_kw, n_tti, mesh, action=None):
    """The job entry of one case: the port's inputs, its single-device
    rollout on the reference's recorded draws (under a power ``action``,
    a numpy (n_cells, n_freq) array, when given), and the mesh to run
    on."""
    k = jax.random.PRNGKey(0)
    static_j, state_j, static_t, state_t = carried(ref, k)
    rec = Recorder(ReplayDraws(k, ref))
    fns_kw = dict(fns_kw, telemetry=True)
    single = port.episode_fns(**fns_kw).rollout(
        static_t, state_t, n_tti, rec,
        None if action is None else torch.as_tensor(action))
    as_dict = lambda nt: {f: np_(v) for f, v in nt._asdict().items()
                          if v is not None}
    roots = {r: np_(getattr(ref, r)._data)
             for r in ("U", "C", "P", "boresight", "fading")}
    roots["buffer"] = np_(ref.buffer._data)
    job = dict(fields=fields_of(ref.params), roots=roots,
               static=as_dict(static_j), state=as_dict(state_j),
               record=rec.record, n_tti=n_tti, fns_kw=fns_kw, mesh=mesh,
               action=action)
    return job, (static_j, state_j), single


def reference_rollout(ref, inputs, fns_kw, n_tti):
    static_j, state_j = inputs
    kw = dict(fns_kw, telemetry=True)
    if kw.get("inc_backend") == "fused":
        kw["inc_backend"] = "xla"     # the reference's rows on the CPU
    with jax.disable_jit(ref.params.traffic_model != "full_buffer"):
        return ref.episode_fns(**kw).rollout(static_j, state_j, n_tti)


def ue_mesh_runs(specs, tmp_dir, dense_arms=False, **job_kw):
    """Each case of ``specs`` (as :data:`UE_CASES`) on the 2-rank UE mesh,
    with the reference's and the port's single-device rollouts:
    ``(rank outputs, reference rollouts, port rollouts)``.  With
    ``dense_arms`` every case also runs dense on the mesh, as
    ``<name>/dense``."""
    cases, singles, pending = {}, {}, []
    for name, (_, fns_kw, kw) in specs.items():
        ref, port = pair(JParams(**BASE, **kw))
        cases[name], inputs, singles[name] = case_of(ref, port, fns_kw,
                                                     N_TTI, UE_MESH)
        pending.append((name, ref, inputs, fns_kw))
        if dense_arms:
            kw_d = dict(cases[name]["fns_kw"], radio_mode="dense")
            kw_d.pop("inc_backend", None)
            cases[f"{name}/dense"] = dict(cases[name], fns_kw=kw_d)
    # the reference's rollouts (eager under bursty traffic: seconds each)
    # run in a thread of this process while the ranks run theirs
    with ThreadPoolExecutor(1) as pool:
        refs = pool.submit(lambda: {
            name: reference_rollout(ref, inputs, fns_kw, N_TTI)
            for name, ref, inputs, fns_kw in pending})
        outs = run_ranks(dict(name="rollouts", cases=cases, **job_kw), 2,
                         tmp_dir)
        return outs, refs.result(), singles


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    ref, _ = pair(JParams(n_ues=9, n_cells=3, pathloss_model_name="UMa"))
    odd, _, _ = case_of(ref, _, {}, 1, UE_MESH)
    return ue_mesh_runs(UE_CASES, tmp_path_factory.mktemp("mesh_engine"),
                        refusals={"ue": (odd, UE_MESH),
                                  "cell": (odd, CELL_MESH)})


def bench_err(got, want):
    """``BENCH_sharded``'s measure: max |difference| / max(max |want|, 1)."""
    want = np_(want)
    return float(np.abs(np_(got) - want).max()
                 / max(float(np.abs(want).max()), 1.0))


def assert_same_values(got, want, name):
    """Equal values (a reassembled +0.0 equals a -0.0)."""
    if want is None:
        assert got is None, name
        return
    got, want = np_(got), np_(want)
    assert got.dtype == want.dtype and got.shape == want.shape, name
    np.testing.assert_array_equal(got, want, err_msg=name)


@pytest.mark.parametrize("name", list(UE_CASES))
def test_ue_mesh_matches_reference(runs, name):
    check_reference(runs, name)


@pytest.mark.parametrize("name", list(UE_CASES))
def test_ue_mesh_matches_port_single_device(runs, name):
    check_single_device(runs, name, UE_CASES[name])


def check_reference(runs, name):
    outs, refs, _ = runs
    s_m, t_m, tel_m, _ = outs[0][name]
    s_j, t_j, tel_j = refs[name]
    np.testing.assert_allclose(t_m, np_(t_j), rtol=RTOL_TPUT, atol=1.0)
    check_state(s_m, s_j)
    check_telemetry(tel_m, tel_j)


def check_single_device(runs, name, spec):
    outs, _, singles = runs
    exact, fns_kw, _ = spec
    s_m, t_m, tel_m, backend = outs[0][name]
    s_1, t_1, tel_1 = singles[name]
    assert backend == fns_kw.get(
        "inc_backend", "torch" if "radio_mode" in fns_kw else None)
    err = bench_err(t_m, t_1)
    print(f"{name}: max |d tput| / max(max |tput|, 1) = {err:.3e}")
    for f in ("U", "serving", "ttt", "harq_retx", "rr_cursor", "t", "seed"):
        assert_same_values(getattr(s_m, f), getattr(s_1, f), f)
    for f in ("harq_acks", "harq_nacks", "harq_retx", "ho_events",
              "dirty_rows"):
        assert_same_values(getattr(tel_m, f), getattr(tel_1, f), f)
    if exact:
        assert err == 0.0
        for f in ("backlog", "pf_avg", "harq_bits"):
            assert_same_values(getattr(s_m, f), getattr(s_1, f), f)
    else:
        assert err <= 1e-5
        for f in ("backlog", "pf_avg", "harq_bits"):
            np.testing.assert_allclose(getattr(s_m, f), np_(getattr(s_1, f)),
                                       rtol=1e-5, err_msg=f)
    for f in ("served_bits", "granted_rb", "dropped_bits", "buffer_bits",
              "jain"):
        np.testing.assert_allclose(getattr(tel_m, f), np_(getattr(tel_1, f)),
                                   rtol=1e-5, atol=1e-3, err_msg=f)


def test_every_rank_returns_the_same_bits(runs):
    same_on_every_rank(runs[0])


# ------------------------------------------------------ in this process
TRIVIAL = [
    (dict(scheduler_policy="rr", harq_bler=0.3, **PO), {}),
    (dict(scheduler_policy="max_cqi", rayleigh_fading=True, n_rb_subbands=4),
     dict(per_tti_fading=True)),
    (dict(scheduler_policy="pf", fairness_p=0.5, ho_enabled=True,
          mobility_step_m=20.0), {}),
    (dict(scheduler_policy="pf", fairness_p=0.5, rayleigh_fading=True),
     dict(radio_mode="incremental", inc_backend="fused",
          mobility_step_m=20.0, mobility_move_frac=0.25)),
]


@pytest.mark.parametrize("kw,fns_kw", TRIVIAL,
                         ids=["rr", "max_cqi", "pf_ho", "inc_fused"])
def test_trivial_mesh_matches_plain_rollout(tmp_path, kw, fns_kw):
    """Every mesh branch -- blocks, collectives, reassembly -- on a 1-rank
    mesh reproduces the plain rollout bit for bit (as
    tests/test_radio_fns.py does on a 1-device mesh), telemetry and
    ``step`` included."""
    sim = TCRRM(TParams(n_ues=16, n_cells=3, seed=3,
                        pathloss_model_name="UMa", power_W=10.0, **kw),
                device="cpu")
    with one_rank_group(tmp_path):
        mesh = make_mesh((1,), ("ue",), "cpu")
        plain = sim.episode_fns(telemetry=True, **fns_kw)
        sharded = sim.episode_fns(telemetry=True, mesh=mesh, **fns_kw)
        assert sharded is not plain
        assert sharded.inc_backend == plain.inc_backend
        static = sim.episode_static()
        for run in (lambda f: f.rollout(static, sim.init_episode_state(), 20,
                                        Draws(0, "cpu")),
                    lambda f: f.step(static, sim.init_episode_state(),
                                     Draws(0, "cpu"))):
            for a, b in zip(run(plain), run(sharded)):
                for x, y in zip(a, b) if isinstance(a, tuple) else [(a, b)]:
                    assert (x is None and y is None) or torch.equal(x, y)


def test_mesh_refusals(tmp_path):
    """The reference's refusals, and the layout checks."""
    sim = TCRRM(TParams(n_ues=9, n_cells=4, pathloss_model_name="UMa",
                        rayleigh_fading=True), device="cpu")
    with pytest.raises(ValueError, match="requires mesh"):
        sim.episode_fns(cell_axis=("cell",))
    with pytest.raises(TypeError, match="Mesh"):
        sim.episode_fns(mesh=object())
    with one_rank_group(tmp_path):
        mesh = make_mesh((1, 1), ("ue", "cell"), "cpu")
        with pytest.raises(ValueError, match="churn"):
            sim.episode_fns(mesh=mesh, churn=ChurnConfig(10.0, 1.0, 2))
        with pytest.raises(ValueError, match="relax"):
            sim.episode_fns(mesh=mesh, relax=RelaxConfig())
        with pytest.raises(ValueError, match="cell-sharded shard"):
            sim.episode_fns(mesh=mesh, cell_axis="cell",
                            radio_mode="incremental", inc_backend="fused",
                            mobility_step_m=5.0)
        auto = sim.episode_fns(mesh=mesh, cell_axis="cell",
                               radio_mode="incremental", inc_backend="auto",
                               mobility_step_m=5.0)
        assert auto.inc_backend == "torch" and "cell block" in auto.inc_reason
        with pytest.raises(ValueError, match="not axes"):
            sim.episode_fns(mesh=mesh, ue_axis="data")
        with pytest.raises(ValueError, match="different mesh axes"):
            sim.episode_fns(mesh=mesh, cell_axis="ue")
        # a batch of envs under a mesh: batch over seeds or shard over UEs
        fns = sim.episode_fns(mesh=mesh)
        static, state = sim.episode_static(), sim.init_episode_state()
        batch = type(state)(*(None if x is None else x[None]
                              for x in state))
        with pytest.raises(ValueError, match="one env"):
            fns.rollout(static, batch, 1, [Draws(0, "cpu")])
    with pytest.raises(RuntimeError, match="init_process_group"):
        make_mesh((1,), ("ue",), "cpu")


def test_mesh_layout_must_divide(runs):
    """On the 2-rank mesh an indivisible UE count (9) and, on the (1, 2)
    mesh, an indivisible cell count (3) are rejected up front."""
    errors = runs[0][0]["refusals"]
    assert "n_ues=9 must divide evenly" in errors["ue"]
    assert "n_cells=3 must divide evenly" in errors["cell"]

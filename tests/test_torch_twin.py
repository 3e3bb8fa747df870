"""The port's digital-twin server (``repro_torch.twin.server``) against the
JAX package's.

Parity runs build the port's simulator on the reference's roots and hand
the port the reference's draws (``torch_parity.seed_draws``: the
reference twin draws from ``radio.episode_key(params.seed)``); Poisson
traffic runs the reference eagerly (``jax.disable_jit``; see
tests/test_torch_engine.py).  Contract: the chunk KPI dicts within rtol
1e-5, the state through ``torch_parity.check_state`` (integer leaves --
``active``, ``serving``, ``cell_state``, ``t`` -- exact, floats to its
tolerances), throughput rtol 1e-4.  Within the port on the CPU: a
restored server resumes bit for bit, N chunks of M TTIs equal one N*M
chunk bit for bit, live control swaps never rebuild the episode
functions, and serving never writes into the simulator's tensors.
"""
import copy

import jax
import numpy as np
import pytest
import torch

from repro.core.crrm import CRRM as JCRRM
from repro.core.params import CRRM_parameters as JParams
from repro.sim import mobility as j_mob
from repro.twin.server import TwinServer as JTwin
from repro_torch import convert
from repro_torch.core.crrm import CRRM
from repro_torch.core.params import CRRM_parameters as TParams
from repro_torch.robust.chaos import _poison
from repro_torch.sim import mobility as t_mob
from repro_torch.train import checkpoint as ckpt
from repro_torch.twin.server import TwinServer
from torch_parity import (RTOL_TPUT, check_state, fields_of,
                          first_divergence, np_, port_of,
                          reference_twin_tree, seed_draws)

BASE = dict(n_ues=48, n_cells=7, n_sectors=1, seed=11,
            pathloss_model_name="UMa", power_W=10.0,
            traffic_model="poisson", scheduler_policy="pf",
            traffic_params=dict(arrival_rate_hz=300.0,
                                packet_size_bits=12_000.0))
CHURN = dict(arrival_rate_hz=400.0, mean_lifetime_s=0.1,
             max_arrivals_per_tti=6)
J_CHURN, T_CHURN = j_mob.ChurnConfig(**CHURN), t_mob.ChurnConfig(**CHURN)
MOVING = dict(radio_mode="incremental", mobility_step_m=10.0,
              mobility_move_frac=0.25)
RTOL_KPI = 1e-5


def twin_pair(params, ref_kw=None, **kw):
    """(reference TwinServer, port TwinServer) on the same roots and
    draws, chunks of 10 TTIs."""
    ref_sim = JCRRM(params)
    ref = JTwin(ref_sim, J_CHURN, chunk_tti=10, **(ref_kw or {}))
    port = TwinServer(port_of(ref_sim), T_CHURN, chunk_tti=10,
                      draws=seed_draws(ref_sim), **kw)
    return ref, port


def port_server(tmp_path=None, **kw):
    p = dict(BASE, **kw.pop("params", {}))
    return TwinServer(CRRM(TParams(**p), device="cpu"), T_CHURN,
                      chunk_tti=10, ckpt_dir=None if tmp_path is None
                      else str(tmp_path), **kw)


def check_kpis(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=RTOL_KPI,
                                   atol=1e-9, err_msg=k)


def check_servers(port, ref):
    check_state(port.state, ref.state)
    np.testing.assert_allclose(np_(port.last_tput), np_(ref.last_tput),
                               rtol=RTOL_TPUT, atol=1.0)


def leaves_equal(a, b):
    for name, x, y in zip(a._fields, a, b):
        assert (x is None) == (y is None), name
        if x is not None:
            assert torch.equal(x, y), name


# ---------------------------------------------------------------- parity
def serve_pair(ref, port, tmp_path, n_chunks=3, controls=None):
    """Serve both servers chunk by chunk, each port chunk started from the
    reference's serving tuple (``convert.twin_tree`` through the port's
    checkpoint and ``restore``); ``controls(chunk, ref)`` may update the
    reference's live controls first.  A chunk whose throughput parts is
    held to its first divergence being a sub-bit residue flip
    (``torch_parity.first_divergence``); every other chunk to the full
    contract.  Returns ``(chunks compared in full, flips)``."""
    full, flips = 0, []
    for c in range(n_chunks):
        with jax.disable_jit():
            if controls is not None:
                controls(c, ref)
            ckpt.save(str(tmp_path), ref.t, convert.twin_tree(
                reference_twin_tree(ref, int(port.state.seed)), "cpu"))
            assert port.restore() == ref.t
            k_ref = ref.step_chunk()
        k_port = port.step_chunk()
        div = first_divergence(port.last_tput, ref.last_tput,
                               port.sim.params.tti_s)
        if div is None:
            check_kpis(k_port, k_ref)
            check_servers(port, ref)
            full += 1
        else:
            assert div[1], (f"chunk {c} parts at TTI {div[0]} without a "
                            "sub-bit residue flip")
            flips.append((c, div[0]))
    return full, flips


def full_buffer_pair(**params_kw):
    """(reference, port) twins under full-buffer traffic, newborns
    full-buffer too: no backlog ever drains, so no residue flip."""
    params = dict(BASE, traffic_model="full_buffer", **params_kw)
    churn = dict(CHURN, newborn_backlog_bits=float("inf"))
    inc = params.get("radio_mode") == "incremental"
    ref_sim = JCRRM(JParams(**params))
    ref = JTwin(ref_sim, j_mob.ChurnConfig(**churn), chunk_tti=10)
    port = TwinServer(port_of(ref_sim), t_mob.ChurnConfig(**churn),
                      chunk_tti=10, draws=seed_draws(ref_sim),
                      inc_backend="fused" if inc else None)
    assert port.fns.inc_backend == ("fused" if inc else None)
    return ref, port


def check_three_chunks(ref, port):
    """Three chunks of each server, held to the whole contract.  The
    traffic is full buffer (:func:`full_buffer_pair`), so the reference
    serves compiled, as the engine tests roll full-buffer runs."""
    k_ref = [ref.step_chunk() for _ in range(3)]
    k_port = [port.step_chunk() for _ in range(3)]
    for got, want in zip(k_port, k_ref):
        check_kpis(got, want)
    assert k_port[-1]["t"] == 30.0
    assert 0 < k_port[-1]["active_ues"] < BASE["n_ues"]
    check_servers(port, ref)


def test_twin_matches_reference_over_three_chunks():
    """Dense radio; the incremental fused route is held to the same in
    tests/test_torch_twin_incremental.py."""
    check_three_chunks(*full_buffer_pair())


@pytest.fixture(scope="module")
def poisson_reference():
    """The reference twin test's own configuration (48 x 7, Poisson
    traffic, chunks of 10, its default episode key) served eagerly once
    and shared by the Poisson cases: chunk 0, then chunks 1-2 with the
    live controls swapped before chunk 1 (``"controls"``) and, from a copy
    of the server after chunk 0, without them (``"plain"``).  Each chunk
    records the serving tuple it started from and what it served.
    Returns ``(reference simulator, {branch: [chunk records]})``."""
    ref_sim = JCRRM(JParams(**BASE))
    ref = JTwin(ref_sim, J_CHURN, chunk_tti=10)

    def serve(server):
        tree, t = reference_twin_tree(server, BASE["seed"]), server.t
        kpis = server.step_chunk()
        return dict(tree=tree, t=t, kpis=kpis, tput=np_(server.last_tput),
                    state=server.state)

    with jax.disable_jit():
        first = serve(ref)
        plain = copy.copy(ref)        # the server rebinds, never mutates
        ref.set_power(np.asarray(ref.power) * 0.7)
        ref.set_fairness(0.8)
        runs = {"controls": [first] + [serve(ref) for _ in range(2)],
                "plain": [first] + [serve(plain) for _ in range(2)]}
    return ref_sim, runs


def port_twin(ref_sim, **kw):
    return TwinServer(port_of(ref_sim), T_CHURN, chunk_tti=10,
                      draws=seed_draws(ref_sim), **kw)


def serve_from_tuple(ref_sim, rec, tmp_path):
    """A port chunk started from the reference's serving tuple of ``rec``
    (``convert.twin_tree`` through the port's checkpoint and ``restore``):
    ``(port server, its KPIs, first divergence)``."""
    port = port_twin(ref_sim, ckpt_dir=str(tmp_path))
    ckpt.save(str(tmp_path), rec["t"], convert.twin_tree(rec["tree"], "cpu"))
    assert port.restore() == rec["t"]
    k_port = port.step_chunk()
    return port, k_port, first_divergence(port.last_tput, rec["tput"],
                                          port.sim.params.tti_s)


def check_recorded(port, k_port, rec):
    check_kpis(k_port, rec["kpis"])
    check_state(port.state, rec["state"])
    np.testing.assert_allclose(np_(port.last_tput), rec["tput"],
                               rtol=RTOL_TPUT, atol=1.0)


@pytest.mark.parametrize("chunk", range(3))
def test_twin_matches_reference_under_poisson_traffic(poisson_reference,
                                                      tmp_path, chunk):
    """Each chunk of the reference's controls run, the port started from
    the reference's tuple (live controls swapped on the reference before
    chunk 1 and carried over by ``convert.twin_tree``).  A chunk whose
    throughput parts must part at a sub-bit residue flip
    (``torch_parity.first_divergence``); else it holds the whole
    contract."""
    ref_sim, runs = poisson_reference
    rec = runs["controls"][chunk]
    port, k_port, div = serve_from_tuple(ref_sim, rec, tmp_path)
    if div is None:
        check_recorded(port, k_port, rec)
    else:
        assert div[1], (f"chunk {chunk} parts at TTI {div[0]} without a "
                        "sub-bit residue flip")
    if chunk:
        assert float(port.fairness) == pytest.approx(0.8)
        assert torch.equal(port.power,
                           torch.as_tensor(rec["tree"]["power"]))


def test_twin_poisson_chunks_mostly_hold_the_whole_contract(
        poisson_reference, tmp_path):
    """With these controls no residue flip parts a chunk: at least two of
    the three chunks hold the whole contract."""
    ref_sim, runs = poisson_reference
    full = 0
    for c, rec in enumerate(runs["controls"]):
        port, k_port, div = serve_from_tuple(ref_sim, rec, tmp_path / str(c))
        if div is None:
            check_recorded(port, k_port, rec)
            full += 1
    assert full >= 2


def test_residue_flip_parts_the_twins_at_the_reference_key(
        poisson_reference):
    """The hazard the Poisson contract allows for (ROADMAP queue 3): left
    to run on, the dense twins of the reference test's configuration part
    at t = 22, and the first divergence is a sub-bit residue flip -- at
    t = 21 the reference drained two UEs' 12 000-bit packets to a 1-ulp
    residue (9.77e-4 bits) that the port drained to 0."""
    ref_sim, runs = poisson_reference
    port = port_twin(ref_sim)
    for c, rec in enumerate(runs["plain"]):
        k_port = port.step_chunk()
        div = first_divergence(port.last_tput, rec["tput"],
                               port.sim.params.tti_s)
        if c < 2:
            assert div is None
            check_recorded(port, k_port, rec)
    assert div == (2, True)
    assert k_port["harq_acks"] == rec["kpis"]["harq_acks"] - 1


# ------------------------------------------------------- within the port
def test_init_episode_state_carries_the_seed():
    sim = CRRM(TParams(**BASE), device="cpu")
    s0, s5 = sim.init_episode_state(), sim.init_episode_state(5)
    assert s0.seed.dtype == torch.int64 and s0.seed.dim() == 0
    assert int(s0.seed) == BASE["seed"] and int(s5.seed) == 5
    leaves_equal(s0._replace(seed=None), s5._replace(seed=None))


def test_twin_restore_bitwise_resume(tmp_path):
    """Kill after a chunk, restore in a fresh server: the resumed KPIs,
    throughput and final state are the uninterrupted run's, bit for bit."""
    srv = port_server(tmp_path)
    srv.step_chunk()
    srv.checkpoint()
    k_ref = [srv.step_chunk() for _ in range(2)]
    tput_ref, final_ref = srv.last_tput, srv.state

    srv2 = port_server(tmp_path)          # fresh process, same ckpt dir
    assert srv2.restore() == 10 == srv2.t
    k_res = [srv2.step_chunk() for _ in range(2)]
    assert k_res == k_ref
    assert torch.equal(srv2.last_tput, tput_ref)
    leaves_equal(srv2.state, final_ref)


@pytest.mark.parametrize("mode", ["dense", "incremental_torch",
                                  "incremental_fused"])
def test_chunks_equal_one_long_chunk(mode):
    """Three chunks of 10 TTIs are one chunk of 30, bit for bit on the CPU
    (every draw keys on the absolute TTI)."""
    kw = {}
    if mode != "dense":
        kw = dict(params=MOVING, inc_backend=mode.split("_")[1])
    short, long_ = port_server(**kw), port_server(**kw)
    long_.chunk_tti = 30
    for _ in range(3):
        short.step_chunk()
    long_.step_chunk()
    leaves_equal(short.state, long_.state)
    assert torch.equal(short.last_tput, long_.last_tput[20:])


def test_twin_restore_async_and_controls(tmp_path):
    """An async checkpoint restores like a blocking one, and the live
    controls (power, fairness) are part of the checkpointed tuple."""
    srv = port_server(tmp_path)
    srv.step_chunk()
    srv.set_power(srv.power * 0.5)
    srv.set_fairness(0.9)
    thread = srv.checkpoint(block=False)
    k_ref = srv.step_chunk()              # serves on while the writer runs
    thread.join(timeout=60)
    assert not thread.is_alive()

    srv2 = port_server(tmp_path)
    srv2.restore()
    assert torch.equal(srv2.power, srv.power)
    assert srv2.fairness.dtype == torch.float32
    assert float(srv2.fairness) == pytest.approx(0.9)
    assert srv2.step_chunk() == k_ref


def test_control_swaps_keep_the_episode_functions(tmp_path):
    """``set_power``/``set_fairness`` swap tensors: ``srv.fns`` and the
    simulator's episode-fns cache stay as they were, and the swap takes
    effect at the next chunk."""
    srv = port_server(tmp_path)
    srv.step_chunk()
    fns, cache = srv.fns, dict(srv.sim._episode_fns_cache)
    kpis = []
    for i in range(3):
        srv.set_power(srv.power * (1.0 + 0.1 * i))
        srv.set_fairness(0.5 + 0.1 * i)
        kpis.append(srv.step_chunk())
    assert srv.fns is fns
    assert srv.sim._episode_fns_cache == cache
    assert kpis[0] != kpis[1]
    # a swapped control is the server's own copy
    P = torch.ones_like(srv.power)
    srv.set_power(P)
    P.mul_(3.0)
    assert torch.equal(srv.power, torch.ones_like(P))


def test_serving_never_writes_into_the_simulator(tmp_path):
    """The server clones the initial state: serving, an in-place write to
    its state, a rollback and a restore leave every graph root and the
    episode statics as they were."""
    from repro_torch.robust.watchdog import WatchdogConfig
    sim = CRRM(TParams(**BASE, **MOVING), device="cpu")
    roots = {n: getattr(sim, n)._data.clone()
             for n in ("U", "C", "P", "boresight", "fading", "buffer")}
    srv = TwinServer(sim, T_CHURN, chunk_tti=10, ckpt_dir=str(tmp_path),
                     inc_backend="fused",
                     watchdog=WatchdogConfig(max_retries=1, backoff_s=0.0))
    static = [x.clone() for x in srv.static]
    for x, name in ((srv.state.U, "U"), (srv.state.backlog, "buffer")):
        assert x.data_ptr() != getattr(sim, name)._data.data_ptr()
    srv.step_chunk()
    srv.state.U.add_(1.0)                 # in place, on the server's copy
    srv.state.backlog.mul_(2.0)
    _poison(srv)
    srv.step_chunk()                      # guard -> rollback -> retry
    srv.restore()
    srv.step_chunk()
    for n, x in roots.items():
        assert torch.equal(getattr(sim, n)._data, x), n
    for x, y in zip(srv.static, static):
        assert torch.equal(x, y)


def test_smoke_cli(capsys):
    from repro_torch.twin import server
    server.main(["--smoke", "--device", "cpu"])
    assert "twin smoke OK on cpu" in capsys.readouterr().out


def test_fields_of_reference_twin_params_build_the_port():
    """The twin's simulator built straight from the reference's fields (no
    carried roots) serves, and a server without ``ckpt_dir`` refuses to
    checkpoint."""
    sim = CRRM(convert.params_from_dict(fields_of(JParams(**BASE))),
               device="cpu")
    srv = TwinServer(sim, T_CHURN, chunk_tti=5)
    assert srv.step_chunk()["t"] == 5.0
    with pytest.raises(ValueError, match="ckpt_dir"):
        srv.checkpoint()
    with pytest.raises(ValueError, match="ckpt_dir"):
        srv.restore()

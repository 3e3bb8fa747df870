"""The port's self-healing layer (``repro_torch.robust``) against the JAX
package's.

The guard's verdicts are held to the reference's ``carry_ok`` on the same
carries, one case per invariant, and its post-mortem lines to the
reference's ``carry_violations`` (JAX spells a field ``.U``, the port
``U``).  The watchdog mirrors the reference's cases (tests/test_faults.py):
NaN rollback resuming bit for bit, a corrupt latest checkpoint fallen
through, a timed-out chunk fenced off, a graceful ``TwinServerDown`` --
and, where the reference degrades ``pallas -> xla``, the port's contract:
recovery retries on the same ``inc_backend`` and a persistent failure
stops with the route named.  The ``outage_storm`` twin and the chaos
drill: ``tests/test_torch_robust_storm.py``.
"""
import functools
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.crrm import CRRM as JCRRM
from repro.core.params import CRRM_parameters as JParams
from repro.mac import engine as j_engine
from repro.robust import guard as j_guard
from repro.sim import mobility as j_mob
from repro.sim.faults import FaultConfig as JFault
from repro_torch import convert
from repro_torch.core.crrm import CRRM
from repro_torch.core.params import CRRM_parameters as TParams
from repro_torch.robust import chaos, guard
from repro_torch.robust.watchdog import (ChunkTimeout, TwinServerDown,
                                         WatchdogConfig, run_with_timeout)
from repro_torch.sim import mobility as t_mob
from repro_torch.train import checkpoint as ckpt
from repro_torch.twin.server import TwinServer
from test_torch_twin import leaves_equal
from torch_parity import np_

STORM = dict(outage_rate_hz=20.0, mean_outage_s=0.03, sleep_rate_hz=20.0,
             mean_sleep_s=0.02, sleep_atten_db=10.0)
TWIN = dict(n_ues=32, n_cells=5, n_sectors=1, seed=9,
            pathloss_model_name="UMa", power_W=10.0, scheduler_policy="pf",
            traffic_model="poisson",
            traffic_params=dict(arrival_rate_hz=300.0,
                                packet_size_bits=12_000.0))
CHURN = dict(arrival_rate_hz=300.0, mean_lifetime_s=0.2,
             max_arrivals_per_tti=4)
FAST = WatchdogConfig(max_retries=2, backoff_s=0.0, ckpt_every_chunks=1)


# ------------------------------------------------------------ the guard
@functools.lru_cache(maxsize=1)
def _carries():
    """A reference state after 5 TTIs under churn and faults, so that every
    leaf kind (``active``, ``fad``, ``cell_state``) is present; JAX arrays
    are immutable, so one is shared."""
    p = JParams(n_ues=24, n_cells=6, n_sectors=1, seed=5,
                pathloss_model_name="UMa", power_W=10.0,
                scheduler_policy="pf", rayleigh_fading=True,
                faults=JFault(**STORM))
    sim = JCRRM(p)
    static = sim.episode_static()
    s0 = j_engine.seed_churn_state(
        sim.init_episode_state(jax.random.PRNGKey(0)), static, p)
    fns = sim.episode_fns(churn=j_mob.ChurnConfig(**CHURN))
    s, _ = fns.rollout(static, s0, 5)
    return s


def _port(state_j, seed=0):
    fields = {k: np_(v) for k, v in state_j._asdict().items()
              if v is not None and k != "key"}
    return convert.episode_state(fields, "cpu")._replace(
        seed=torch.tensor(seed, dtype=torch.int64))


def _poison(state_j, leaf, index, value):
    x = getattr(state_j, leaf)
    return state_j._replace(**{leaf: x.at[index].set(value)})


INVARIANTS = {
    "healthy": None,
    "U_nan": ("U", (0, 0), jnp.nan),
    "U_inf": ("U", (3, 1), jnp.inf),
    "pf_avg_negative": ("pf_avg", 1, -1.0),
    "pf_avg_inf": ("pf_avg", 1, jnp.inf),
    "harq_bits_inf": ("harq_bits", 0, jnp.inf),
    "harq_bits_negative": ("harq_bits", 0, -1.0),
    "backlog_negative": ("backlog", 2, -5.0),
    "backlog_nan": ("backlog", 2, jnp.nan),
    "backlog_inf_is_legal": ("backlog", slice(None), jnp.inf),
    "fad_nan": ("fad", (4, 2), jnp.nan),
    "t_negative": ("t", (), -1),
}


@pytest.mark.parametrize("case", list(INVARIANTS))
def test_guard_verdicts_match_reference(case):
    s = _carries()
    if INVARIANTS[case] is not None:
        s = _poison(s, *INVARIANTS[case])
    want = bool(j_guard.carry_ok(s))
    assert want == (case in ("healthy", "backlog_inf_is_legal"))
    port = _port(s)
    assert guard.carry_ok(port) is want
    lines_j = [line.lstrip(".") for line in j_guard.carry_violations(s)]
    assert guard.carry_violations(port) == lines_j
    assert guard.tree_has_nan(port) == j_guard.tree_has_nan(s)


def test_guard_on_a_batched_carry():
    """One poisoned env fails the whole batch, as the reference's ``.all()``
    over every axis does."""
    s = _carries()
    bad = _poison(s, "pf_avg", 3, -2.0)
    stack = lambda *xs: jax.tree_util.tree_map(lambda *a: jnp.stack(a), *xs)
    for pair, ok in (((s, s), True), ((s, bad), False)):
        j = stack(*pair)
        assert bool(j_guard.carry_ok(j)) is ok
        port = type(_port(s))(*(
            None if a is None else torch.stack([a, b])
            for a, b in zip(_port(pair[0]), _port(pair[1]))))
        assert guard.carry_ok(port) is ok


def test_guard_reads_back_once(monkeypatch):
    """``carry_ok`` stacks its verdicts on the device and reads one."""
    calls = []
    real = torch.Tensor.item
    monkeypatch.setattr(torch.Tensor, "item",
                        lambda self: calls.append(1) or real(self))
    assert guard.carry_ok(_port(_carries()))
    assert len(calls) == 1


def test_run_with_timeout():
    assert run_with_timeout(lambda: 41 + 1, None) == 42
    assert run_with_timeout(lambda: "fast", 5.0) == "fast"
    with pytest.raises(ZeroDivisionError):
        run_with_timeout(lambda: 1 / 0, 5.0)
    with pytest.raises(ChunkTimeout):
        run_with_timeout(lambda: time.sleep(1.0), 0.05)


# -------------------------------------------------------- the watchdog
def _twin(tmpdir, watchdog=None, params=None, **kw):
    p = TParams(**dict(TWIN, **(params or {})))
    return TwinServer(CRRM(p, device="cpu"), t_mob.ChurnConfig(**CHURN),
                      chunk_tti=10,
                      ckpt_dir=None if tmpdir is None else str(tmpdir),
                      watchdog=watchdog, **kw)


def test_watchdog_requires_ckpt_dir():
    with pytest.raises(ValueError, match="ckpt_dir"):
        _twin(None, watchdog=True)


def test_watchdog_nan_rollback_resumes_bitwise(tmp_path):
    """A poisoned carry trips the guard; the rolled-back retry reaches the
    uninterrupted run's state bit for bit."""
    ref = _twin(tmp_path / "ref")
    for _ in range(3):
        k_ref = ref.step_chunk()
    srv = _twin(tmp_path / "wd", watchdog=FAST)
    srv.step_chunk()
    chaos._poison(srv)
    srv.step_chunk()
    k = srv.step_chunk()
    assert any("GuardViolation" in line and "U: " in line
               for line in srv.fault_history)
    assert srv.t == ref.t and k == k_ref
    leaves_equal(srv.state, ref.state)


def test_watchdog_survives_corrupt_latest_checkpoint(tmp_path):
    ref = _twin(tmp_path / "ref")
    for _ in range(3):
        ref.step_chunk()
    srv = _twin(tmp_path / "wd", watchdog=FAST)
    srv.step_chunk()
    srv.step_chunk()
    chaos._corrupt_latest(srv.ckpt_dir)          # newest checkpoint bad
    chaos._poison(srv)
    # the rollback skips the corrupt step_20 to step_10; the recovery chunk
    # re-runs [10, 20), one more chunk reaches the uninterrupted t = 30
    srv.step_chunk()
    assert srv.t == ref.t - srv.chunk_tti
    assert any("rolled back to t=10" in line for line in srv.fault_history)
    srv.step_chunk()
    leaves_equal(srv.state, ref.state)


def test_watchdog_chunk_timeout_recovers(tmp_path):
    """A hung chunk is abandoned at the timeout, rolled back and re-run;
    the abandoned attempt's late result never commits."""
    srv = _twin(tmp_path)
    srv.step_chunk()
    srv.watchdog = WatchdogConfig(max_retries=2, backoff_s=0.0,
                                  chunk_timeout_s=1.0, ckpt_every_chunks=1)
    srv.checkpoint()                             # rollback target
    t0 = srv.t
    real, armed = srv._chunk, {"on": True}

    def slow(static, state, power, fairness):
        if armed["on"]:
            armed["on"] = False
            time.sleep(2.0)
        return real(static, state, power, fairness)

    srv._chunk = slow
    srv.step_chunk()
    assert any("ChunkTimeout" in line for line in srv.fault_history)
    assert srv.t == t0 + srv.chunk_tti
    # serve across the abandoned worker's wake-up, then check continuity
    expect = srv.t
    for _ in range(3):
        time.sleep(0.4)
        srv.step_chunk()
        expect += srv.chunk_tti
        assert srv.t == expect, "an abandoned chunk clobbered the state"


def test_generation_fencing_discards_a_superseded_chunk(tmp_path):
    """A chunk still running when a restore lands raises instead of
    committing its result over the restored state."""
    srv = _twin(tmp_path)
    srv.step_chunk()
    srv.checkpoint()
    srv.step_chunk()
    gate, real, box = threading.Event(), srv._chunk, {}

    def blocked(*a):
        gate.wait(30)
        return real(*a)

    def worker():
        try:
            srv._step_chunk_raw()
        except RuntimeError as e:
            box["error"] = e

    srv._chunk = blocked
    th = threading.Thread(target=worker, daemon=True)
    th.start()
    assert srv.restore() == 10
    restored = srv.state
    gate.set()
    th.join(30)
    assert not th.is_alive()
    assert "stale chunk result discarded" in str(box["error"])
    assert srv.state is restored and srv.t == 10


def test_watchdog_gives_up_gracefully(tmp_path):
    srv = _twin(tmp_path, watchdog=WatchdogConfig(max_retries=1,
                                                  backoff_s=0.0))
    srv.step_chunk()

    def explode(*a):
        raise RuntimeError("persistent kernel failure")

    srv._chunk = explode
    with pytest.raises(TwinServerDown) as ei:
        srv.step_chunk()
    assert len(ei.value.history) >= 2
    assert "persistent kernel failure" in str(ei.value)


def test_watchdog_retries_on_the_same_route(tmp_path):
    """Where the reference degrades ``pallas -> xla`` on a chunk exception
    (tests/test_faults.py::test_watchdog_degrades_pallas_to_xla), the port
    rolls back and retries on ``inc_backend="fused"``: the episode
    functions stay the fused ones and no line says "degrading".  A failure
    that persists ends in ``TwinServerDown`` naming the route."""
    srv = _twin(tmp_path, radio_mode="incremental", inc_backend="fused",
                watchdog=FAST, params=dict(mobility_step_m=10.0,
                                           mobility_move_frac=0.25))
    fns = srv.fns
    assert fns.inc_backend == "fused"
    srv.step_chunk()
    real, boom = srv._chunk, {"armed": True}

    def explode_once(*a):
        if boom["armed"]:
            boom["armed"] = False
            raise RuntimeError("fused kernel fell over")
        return real(*a)

    srv._chunk = explode_once
    k = srv.step_chunk()
    assert srv.t == 20 and np.isfinite(list(k.values())).all()
    assert srv.inc_backend == "fused" and srv.fns is fns
    assert not any("degrad" in line for line in srv.fault_history)
    assert any("inc_backend='fused'" in line and "fell over" in line
               for line in srv.fault_history)

    def explode(*a):
        raise RuntimeError("fused kernel keeps falling over")

    srv._chunk = explode
    with pytest.raises(TwinServerDown) as ei:
        srv.step_chunk()
    assert "inc_backend='fused'" in str(ei.value)
    assert sum("keeps falling over" in line
               for line in ei.value.history) == FAST.max_retries + 1
    assert srv.inc_backend == "fused" and srv.fns is fns


def test_failed_rollback_stops_gracefully(tmp_path):
    """With every checkpoint corrupt the rollback fails too: the server
    stops with ``TwinServerDown`` at once, the cause chained."""
    srv = _twin(tmp_path, watchdog=FAST)
    srv.step_chunk()
    for step in ckpt.all_steps(srv.ckpt_dir):
        with open(f"{srv.ckpt_dir}/step_{step:010d}/manifest.json",
                  "w") as f:
            f.write("garbage")
    chaos._poison(srv)
    with pytest.raises(TwinServerDown, match="rollback failed") as ei:
        srv.step_chunk()
    assert isinstance(ei.value.__cause__, ckpt.CheckpointCorrupt)
    assert ei.value.history[-1].startswith("rollback failed")

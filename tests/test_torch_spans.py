"""The port's host-only spans (``repro_torch.obs.profile``), at toy size on
the CPU under a profiler.

A rollout, an env step and a guarded twin chunk each open the spans of
``profile.SPANS`` in the nesting that table states: a TTI's stages inside
its ``crrm.tti``, that inside the call's ``crrm.rollout``, that inside an
env step or a twin chunk.  With no profiler recording, ``annotate``
returns one shared no-op, and a rollout's outputs are bitwise the same
with the profiler on and off.
"""
import re
from pathlib import Path

import pytest
import torch

from repro_torch.core.crrm import CRRM
from repro_torch.core.params import CRRM_parameters
from repro_torch.env import CrrmEnv
from repro_torch.mac.engine import Draws, seed_churn_state
from repro_torch.obs import annotate, profile
from repro_torch.robust.watchdog import WatchdogConfig
from repro_torch.sim.faults import FaultConfig
from repro_torch.sim.mobility import ChurnConfig
from repro_torch.twin.server import TwinServer

SRC = Path(__file__).resolve().parents[1] / "src" / "repro_torch"

BASE = dict(n_ues=40, n_cells=7, n_sectors=1, seed=3,
            pathloss_model_name="UMa", power_W=10.0, scheduler_policy="pf",
            fairness_p=0.5, mobility_step_m=20.0, mobility_move_frac=0.25)
POISSON = dict(traffic_model="poisson",
               traffic_params=dict(arrival_rate_hz=300.0,
                                   packet_size_bits=12_000.0))
STORM = FaultConfig(outage_rate_hz=5.0, mean_outage_s=0.03,
                    sleep_rate_hz=5.0, mean_sleep_s=0.02,
                    sleep_atten_db=10.0)
CHURN = ChurnConfig(arrival_rate_hz=400.0, mean_lifetime_s=0.1,
                    max_arrivals_per_tti=6)

#: every stage on: churn, faults, handover, traffic, HARQ, telemetry
ALL_STAGES = ("crrm.churn", "crrm.faults", "crrm.radio", "crrm.handover",
              "crrm.traffic", "crrm.sched", "crrm.harq", "crrm.telemetry")
#: the full-buffer, fault-free, A3-free rollout of the 1M benchmark cells
BARE_STAGES = ("crrm.radio", "crrm.sched", "crrm.harq")


def profiled(fn):
    """``(fn(), [(name, start_us, end_us)])``: the crrm spans recorded
    while ``fn`` ran under a CPU profiler, in start order."""
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        out = fn()
    spans = sorted(((e.name, e.time_range.start, e.time_range.end)
                    for e in prof.events() if e.name.startswith("crrm.")),
                   key=lambda s: s[1])
    return out, spans


def named(spans, name):
    return [s for s in spans if s[0] == name]


def inside(inner, outer):
    return outer[1] <= inner[1] and inner[2] <= outer[2]


def within(spans, name, outer):
    return [s for s in named(spans, name) if inside(s, outer)]


def rollout_case(stages):
    """(fns, static, state) of a 40-UE incremental episode with the given
    stages on."""
    every = stages == "all"
    params = CRRM_parameters(
        **BASE, radio_mode="incremental",
        **(dict(POISSON, harq_bler=0.1, ho_enabled=True, faults=STORM)
           if every else {}))
    sim = CRRM(params, device="cpu")
    fns = sim.episode_fns(telemetry=every, churn=CHURN if every else None)
    static, state = sim.episode_static(), sim.init_episode_state()
    if every:
        state = seed_churn_state(state, static, params)
    return fns, static, state


@pytest.mark.parametrize("stages", ["all", "bare"])
def test_incremental_rollout_opens_each_stage_once_a_tti(stages):
    fns, static, state = rollout_case(stages)
    _, spans = profiled(lambda: fns.rollout(static, state, 3,
                                            Draws(0, "cpu")))
    (call,) = named(spans, "crrm.rollout")
    assert len(within(spans, "crrm.radio_init", call)) == 1
    ttis = within(spans, "crrm.tti", call)
    assert len(ttis) == 3
    want = ALL_STAGES if stages == "all" else BARE_STAGES
    for tti in ttis:
        for name in want:
            assert len(within(spans, name, tti)) == 1, (name, tti)
    # a disabled stage opens nothing; every span is in the table
    assert {s[0] for s in spans} == {"crrm.rollout", "crrm.radio_init",
                                     "crrm.tti", *want}


def test_dense_rollout_puts_its_chain_in_radio_spans():
    params = CRRM_parameters(**BASE, radio_mode="dense", ho_enabled=True)
    sim = CRRM(params, device="cpu")
    fns = sim.episode_fns()
    static, state = sim.episode_static(), sim.init_episode_state()
    _, spans = profiled(lambda: fns.step(static, state, Draws(0, "cpu")))
    (tti,) = named(spans, "crrm.tti")
    assert len(within(spans, "crrm.radio", tti)) == 2    # R, then SINR
    assert len(within(spans, "crrm.handover", tti)) == 1
    assert named(spans, "crrm.radio_init")


def test_rollout_outputs_are_bitwise_with_and_without_the_profiler():
    fns, static, state = rollout_case("all")
    run = lambda: fns.rollout(static, state, 3, Draws(0, "cpu"))
    plain = run()
    traced, spans = profiled(run)
    assert spans
    s0, t0, tel0 = plain
    s1, t1, tel1 = traced
    assert torch.equal(t0, t1)
    for name, a, b in zip(s0._fields, s0, s1):
        assert (a is None) == (b is None), name
        assert a is None or torch.equal(a, b), name
    for name, a, b in zip(tel0._fields, tel0, tel1):
        assert a is None or torch.equal(a, b), name


def test_autoreset_step_nests_the_rollout_reset_and_score():
    env = CrrmEnv(CRRM_parameters(**BASE, **POISSON, radio_mode="incremental"),
                  tti_per_step=2, episode_tti=4, telemetry=True, device="cpu")
    state, _ = env.reset(0)
    _, spans = profiled(lambda: env.step_autoreset(
        state, env.uniform_action(), reset_seed=5))
    (step,) = named(spans, "crrm.env.step")      # the outermost alone
    for name in ("crrm.rollout", "crrm.env.reset", "crrm.env.score"):
        assert len(within(spans, name, step)) == 1, name
    assert len(within(spans, "crrm.tti", step)) == 2


def test_batched_autoreset_opens_one_env_step():
    env = CrrmEnv(CRRM_parameters(**BASE, radio_mode="incremental"),
                  tti_per_step=2, episode_tti=4, device="cpu")
    states, _ = env.reset_batch([0, 1])
    _, spans = profiled(lambda: env.step_autoreset_batch(
        states, None, [7, 8]))
    (step,) = named(spans, "crrm.env.step")
    assert len(within(spans, "crrm.rollout", step)) == 1
    assert len(within(spans, "crrm.radio_init", step)) == 2   # one an env
    assert len(within(spans, "crrm.tti", step)) == 2
    assert len(within(spans, "crrm.env.reset", step)) == 1
    assert len(within(spans, "crrm.env.score", step)) == 1


def test_guarded_twin_chunk_nests_summary_guard_and_checkpoint(tmp_path):
    sim = CRRM(CRRM_parameters(**BASE, **POISSON, radio_mode="incremental"),
               device="cpu")
    srv = TwinServer(sim, CHURN, chunk_tti=2, ckpt_dir=str(tmp_path),
                     watchdog=WatchdogConfig(backoff_s=0.0))
    _, spans = profiled(srv.step_chunk)
    (chunk,) = named(spans, "crrm.twin.chunk")
    for name in ("crrm.rollout", "crrm.twin.summary", "crrm.twin.guard",
                 "crrm.twin.checkpoint"):
        assert len(within(spans, name, chunk)) == 1, name
    assert len(within(spans, "crrm.tti", chunk)) == 2
    _, spans = profiled(srv.restore)
    assert [s[0] for s in spans] == ["crrm.twin.restore"]


def test_annotate_without_a_profiler_is_one_shared_no_op():
    assert annotate("crrm.tti") is annotate("crrm.radio")
    with annotate("crrm.tti") as x:
        assert x is None
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        assert annotate("crrm.tti") is not annotate("crrm.tti")


def test_spans_are_host_operations_not_user_annotations():
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with annotate("crrm.tti"):
            torch.ones(4).sum()
    (ev,) = [e for e in prof.events() if e.name == "crrm.tti"]
    assert ev.device_type == torch.autograd.DeviceType.CPU
    assert not ev.is_user_annotation


def test_the_span_table_names_every_span_of_the_source():
    used = set()
    for path in SRC.rglob("*.py"):
        used |= set(re.findall(r'annotate\("(crrm\.[a-z_.]+)"\)',
                               path.read_text()))
    assert used == set(profile.SPANS)

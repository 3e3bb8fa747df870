"""Named scenario presets: reproducible 3GPP-flavoured configurations.

A copy of ``repro.sim.scenarios``: the same registry API and the same seven
presets, each a registry entry mapping a name to the keyword arguments of
:class:`~repro_torch.core.params.CRRM_parameters`.  Callers override any
field (e.g. shrink ``n_ues`` for CI) without losing the preset's identity:

>>> from repro_torch.sim.scenarios import make_scenario
>>> from repro_torch.core.crrm import CRRM
>>> sim = CRRM(make_scenario("dense_urban", n_ues=50), device="cpu")

``outage_storm`` bakes in a ``FaultConfig``: ``CRRM.episode_fns`` and
``CrrmEnv`` run its fault process by default.  ``repro_torch.env.CrrmEnv``
accepts a scenario name directly.
"""
from __future__ import annotations

from typing import Callable, Dict

from repro_torch.core.params import CRRM_parameters
from repro_torch.sim.faults import FaultConfig

#: name -> (description, factory(**overrides) -> CRRM_parameters)
_REGISTRY: Dict[str, tuple] = {}


def register_scenario(name: str, description: str,
                      factory: Callable[..., CRRM_parameters],
                      overwrite: bool = False) -> None:
    """Register a named scenario.  ``factory(**overrides)`` must return a
    fresh ``CRRM_parameters``; user code can extend the registry with its
    own presets (``overwrite=True`` to replace a stock one)."""
    if name in _REGISTRY and not overwrite:
        raise ValueError(f"scenario {name!r} already registered "
                         f"(pass overwrite=True to replace)")
    _REGISTRY[name] = (description, factory)


def _preset(name: str, description: str, **base):
    """Register a dict-based preset; overrides shallow-merge over ``base``."""
    def factory(**overrides) -> CRRM_parameters:
        kw = dict(base)
        kw.update(overrides)
        return CRRM_parameters(**kw)

    register_scenario(name, description, factory)


def scenario_names() -> tuple:
    """Registered preset names, sorted."""
    return tuple(sorted(_REGISTRY))


def scenario_description(name: str) -> str:
    return _get(name)[0]


def _get(name: str):
    try:
        return _REGISTRY[name]
    except KeyError:
        raise ValueError(f"unknown scenario {name!r}; "
                         f"have {list(scenario_names())}") from None


def make_scenario(name: str, **overrides) -> CRRM_parameters:
    """Construct the named preset's ``CRRM_parameters``.

    ``overrides`` replace any preset field (validated by
    ``CRRM_parameters.__post_init__`` as usual), so shrinking a scenario
    for CI keeps its identity: ``make_scenario("rural_macro", n_ues=20)``.
    """
    return _get(name)[1](**overrides)


# ---------------------------------------------------------------------------
# stock presets
# ---------------------------------------------------------------------------
_preset(
    "dense_urban",
    "Interference-limited street-canyon microcells: 3-sector UMi sites at "
    "3.5 GHz, frequency-selective fading with per-RB CQI, heavy Poisson "
    "load on a PF scheduler.",
    n_ues=200, n_cells=21, n_sectors=3, extent_m=1200.0,
    pathloss_model_name="UMi", fc_GHz=3.5, h_bs_m=10.0,
    power_W=6.3,                       # 38 dBm micro BS
    rayleigh_fading=True, n_rb_subbands=4, coherence_rb=3,
    scheduler_policy="pf", fairness_p=0.5,
    traffic_model="poisson",
    traffic_params=dict(arrival_rate_hz=400.0, packet_size_bits=12_000.0),
    harq_bler=0.1, seed=0)

_preset(
    "dense_urban_mobile",
    "dense_urban with a baked-in mobility trajectory: every UE takes a "
    "bounded random-walk step each TTI (time-compressed vehicular churn), "
    "with A3 handover armed so episodes exercise mobility-driven serving-"
    "cell dynamics out of the box (mobility_step_m rides in the preset -- "
    "run_episode/CrrmEnv pick it up without extra arguments).",
    n_ues=200, n_cells=21, n_sectors=3, extent_m=1200.0,
    pathloss_model_name="UMi", fc_GHz=3.5, h_bs_m=10.0,
    power_W=6.3,
    rayleigh_fading=True, n_rb_subbands=4, coherence_rb=3,
    attach_ignores_fading=True,
    mobility_step_m=5.0,               # ~city-block drift per episode
    ho_enabled=True, ho_hysteresis_db=3.0, ho_ttt_tti=4,
    scheduler_policy="pf", fairness_p=0.5,
    traffic_model="poisson",
    traffic_params=dict(arrival_rate_hz=400.0, packet_size_bits=12_000.0),
    harq_bler=0.1, seed=0)

_preset(
    "dense_urban_twin",
    "The digital-twin regime of dense_urban_mobile: a mostly-static UE "
    "field where only 10% of UEs move per TTI (mobility_move_frac), with "
    "the radio chain running in the incremental (smart-update-in-scan) "
    "mode -- only the movers' rows re-run D..SE inside the compiled "
    "engine.  The preset that demonstrates the paper's compute-on-demand "
    "contribution at episode scale (benchmarks/BENCH_smart_update.json).",
    n_ues=200, n_cells=21, n_sectors=3, extent_m=1200.0,
    pathloss_model_name="UMi", fc_GHz=3.5, h_bs_m=10.0,
    power_W=6.3,
    rayleigh_fading=True, n_rb_subbands=4, coherence_rb=3,
    attach_ignores_fading=True,
    mobility_step_m=5.0, mobility_move_frac=0.1,
    radio_mode="incremental",
    ho_enabled=True, ho_hysteresis_db=3.0, ho_ttt_tti=4,
    scheduler_policy="pf", fairness_p=0.5,
    traffic_model="poisson",
    traffic_params=dict(arrival_rate_hz=400.0, packet_size_bits=12_000.0),
    harq_bler=0.1, seed=0)

_preset(
    "rural_macro",
    "Noise-limited wide-area coverage: RMa macro sites at 700 MHz over an "
    "8 km extent, bursty FTP-3 file downloads, round-robin airtime.",
    n_ues=120, n_cells=7, n_sectors=1, extent_m=8000.0,
    pathloss_model_name="RMa", fc_GHz=0.7, h_bs_m=35.0,
    power_W=40.0,                      # 46 dBm macro BS
    scheduler_policy="rr",
    traffic_model="ftp3",
    traffic_params=dict(file_rate_hz=0.5, file_size_bits=4_000_000.0),
    seed=0)

_preset(
    "indoor_hotspot",
    "LOS-dominated office floor: InH ceiling cells at 3.5 GHz over a "
    "120 m extent, full-buffer UEs on an opportunistic max-CQI scheduler "
    "riding per-RB fading peaks.",
    n_ues=40, n_cells=4, n_sectors=1, extent_m=120.0,
    pathloss_model_name="InH", fc_GHz=3.5, h_bs_m=3.0, h_ut_m=1.0,
    power_W=0.25,                      # 24 dBm pico BS
    rayleigh_fading=True, n_rb_subbands=6, coherence_rb=1,
    scheduler_policy="max_cqi", traffic_model="full_buffer", seed=0)

_preset(
    "outage_storm",
    "Resilience what-if: the handover_stress deployment under a cell "
    "fault storm -- every cell walks a Markov outage/sleep chain inside "
    "the compiled scan (sim.faults), so dark cells appear and recover "
    "mid-episode and A3 reattachment compensates through the unmodified "
    "radio chain.  Mobility keeps the A3 machine hot; the fault rates "
    "put ~13%% of cells in outage at stationarity (DESIGN.md "
    "§Fault-injection-and-self-healing; benchmarks/BENCH_faults.json "
    "gates the storm's overhead vs the fault-free twin).",
    n_ues=150, n_cells=19, n_sectors=1, extent_m=1500.0,
    pathloss_model_name="UMa", fc_GHz=3.5, h_bs_m=25.0, power_W=10.0,
    rayleigh_fading=True, attach_ignores_fading=True,
    mobility_step_m=5.0,
    ho_enabled=True, ho_hysteresis_db=3.0, ho_ttt_tti=4,
    faults=FaultConfig(outage_rate_hz=5.0, mean_outage_s=0.03,
                       sleep_rate_hz=5.0, mean_sleep_s=0.02,
                       sleep_atten_db=10.0),
    harq_bler=0.1, scheduler_policy="pf",
    traffic_model="poisson",
    traffic_params=dict(arrival_rate_hz=300.0, packet_size_bits=12_000.0),
    seed=0)

_preset(
    "handover_stress",
    "Mobility-driven handover churn: dense UMa grid with A3 handover "
    "(3 dB hysteresis, 4-TTI time-to-trigger) and HARQ; roll episodes "
    "with mobility_step_m set to exercise the A3 state machine.",
    n_ues=150, n_cells=19, n_sectors=1, extent_m=1500.0,
    pathloss_model_name="UMa", fc_GHz=3.5, h_bs_m=25.0, power_W=10.0,
    rayleigh_fading=True, attach_ignores_fading=True,
    ho_enabled=True, ho_hysteresis_db=3.0, ho_ttt_tti=4,
    harq_bler=0.1, scheduler_policy="pf",
    traffic_model="poisson",
    traffic_params=dict(arrival_rate_hz=300.0, packet_size_bits=12_000.0),
    seed=0)

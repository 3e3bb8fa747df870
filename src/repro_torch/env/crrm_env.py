"""CrrmEnv: a functional, gym-style environment over CRRM.

The port of ``repro.env.crrm_env`` on one device:

* ``reset(seed) -> (state, EnvObs)`` and
  ``step(state, action, fairness_p) -> (state, EnvObs, reward, done)`` are
  functions of their arguments -- no hidden attributes, so episodes can be
  checkpointed, replayed, or driven by any external RL loop;
* the *action* is a per-cell/subband transmit-power matrix; each ``step``
  holds it for ``tti_per_step`` TTIs of the MAC engine and observes the
  delivered throughput and residual backlog.

Randomness: the reference threads a PRNG key through the state; here the
state carries the episode seed (``EpisodeState.seed``) and TTI, and each
``step`` draws through ``draws(seed, device)`` -- a ``mac.engine.Draws``
by default, or any factory with its interface (the parity tests replay the
reference's draws through it).  A resampled reset's topology and fading
come from the same object (``Draws.topology``/``topology_fading``).

Two regimes, as in the reference:

* default (``resample_topology=False``): the radio topology is frozen at
  construction; the threaded state is a bare ``EpisodeState``.
* ``resample_topology=True``: every ``reset`` redraws the UE field and the
  fading from its seed and recomputes the radio chain (one
  ``radio.radio_forward``); the state is a :class:`TopoEnvState`.

The batched surfaces (``reset_batch``, ``step_batch``,
``step_autoreset_batch``) run B episodes from B seeds as one batched
state: every leaf leads with B, and each env keeps its own seed, TTI
counter and draws, so row b of a batch is the single episode of seed b.
``churn=`` runs the birth-death UE process and ``faults=`` the per-cell
fault process inside every decision window (``faults`` defaults to the
params', as ``outage_storm`` sets it).  ``mesh=`` shards the UE axis of
the engine over a ``core.distributed.Mesh`` (each rank steps the global
state and gets it back); the batched surfaces then raise.

Each step call opens the host-only span ``crrm.env.step`` (an autoreset's
fresh episode ``crrm.env.reset``, the scoring ``crrm.env.score``) around
the engine's own spans (``repro_torch.obs.profile.SPANS``).

>>> env = CrrmEnv(scenario="dense_urban", scenario_overrides=dict(n_ues=50),
...               device="cpu")
>>> state, obs = env.reset(0)
>>> state, obs, reward, done = env.step(state, env.uniform_action())
"""
from __future__ import annotations

from typing import Any, NamedTuple, Optional

import torch

from repro_torch.core.crrm import CRRM
from repro_torch.core.params import CRRM_parameters
from repro_torch.mac.engine import (Draws, env_slice, seed_churn_state,
                                     stationary_served_tput)
from repro_torch.obs.profile import annotate
from repro_torch.sim import radio


class EnvObs(NamedTuple):
    """What the agent sees after one decision step.

    ``tput`` is the mean delivered throughput over the decision window
    (bits/s per UE); ``backlog`` the residual queued bits at its end
    (``inf`` under full-buffer traffic).
    """

    tput: Any
    backlog: Any


class TopoEnvState(NamedTuple):
    """The threaded state of a topology-resampling episode: the MAC carry
    (``ep``: an ``EpisodeState``) plus the episode's own radio inputs
    (``static``: an ``EpisodeStatic`` recomputed by ``reset``)."""

    ep: Any
    static: Any


def expand_action(params, action):
    """(n_cells, n_subbands) watts -> the (n_cells, n_freq) power grid.

    Clamp each cell's total to the ``power_W`` budget (rows under budget
    pass through), then split each subband's power evenly over its
    ``n_rb_subbands`` CQI chunks.
    """
    action = torch.as_tensor(action, dtype=torch.float32)
    total = action.sum(dim=-1, keepdim=True)
    budget = params.power_W
    action = action * torch.clamp(budget / torch.clamp(total, min=1e-30),
                                  max=1.0)
    s = params.n_rb_subbands
    if s > 1:
        action = torch.repeat_interleave(action, s, dim=-1) / s
    return action


def _queue_term(backlog):
    return torch.where(torch.isfinite(backlog), torch.log1p(backlog / 1e4),
                       0.0)


def reward_components(obs: EnvObs, telem, tti_s: float):
    """The per-cell / per-term decomposition of the default reward:
    ``goodput_term`` minus ``queue_penalty`` IS :func:`buffer_aware_reward`,
    plus each serving cell's mean delivered rate and granted RBs."""
    n_tti = telem.served_bits.shape[0]
    return {
        "goodput_term": torch.log(torch.clamp(obs.tput, min=1e3)).mean(),
        "queue_penalty": 0.05 * _queue_term(obs.backlog).mean(),
        # (n_cells,) mean delivered rate / granted RBs per serving cell
        "cell_tput_mbps": telem.served_bits.sum(dim=0) / (n_tti * tti_s)
                          / 1e6,
        "cell_granted_rb": telem.granted_rb.mean(dim=0),
    }


def buffer_aware_reward(obs: EnvObs):
    """Default reward: geometric-mean goodput minus a queueing penalty
    (full-buffer UEs, with infinite backlog, are exempt from the queue
    term)."""
    goodput = torch.log(torch.clamp(obs.tput, min=1e3)).mean()
    return goodput - 0.05 * _queue_term(obs.backlog).mean()


class CrrmEnv:
    """Gym-style environment over the MAC engine (one episode at a time).

    Parameters
    ----------
    params, scenario, scenario_overrides, sim:
        Explicit ``CRRM_parameters``, or a named preset of
        ``repro_torch.sim.scenarios`` plus per-field overrides, or an
        already-built ``CRRM`` to wrap (its topology, e.g. one carried over
        from the reference with ``repro_torch.convert``); exactly one.
    episode_tti:
        Episode horizon; ``done`` once the state's TTI counter reaches it.
    tti_per_step:
        MAC TTIs rolled per ``step`` call -- the agent's decision interval.
    per_tti_fading:
        Redraw fast fading every TTI (otherwise the construction-time or
        reset-time draw stays frozen).
    resample_topology:
        Redraw the UE field and fading per ``reset`` seed and recompute the
        radio chain inside ``reset``; the state becomes a
        :class:`TopoEnvState`.
    reward_fn:
        ``EnvObs -> scalar``; defaults to :func:`buffer_aware_reward`.
    radio_mode:
        ``"dense"`` | ``"incremental"`` radio inside the engine (``None``
        defers to ``params.radio_mode``).
    telemetry:
        ``step`` returns a fifth element, ``{"telemetry": Telemetry,
        "reward_components": dict}``, the KPIs stacked to
        (tti_per_step, ...).  The trajectory is bit-identical either way.
    device:
        ``None`` means the CUDA device (raises without one); pass ``"cpu"``
        to run on the CPU.  With ``sim=`` the simulator's device is used.
    draws:
        ``draws(seed, device) -> Draws``: the episode's random draws from
        its seed (default :class:`~repro_torch.mac.engine.Draws`).
    churn:
        A ``sim.mobility.ChurnConfig``: the birth-death UE process runs in
        every decision window (the capacity-padded ``active`` mask rides
        the state) and the telemetry gains ``active_ues``.  Incompatible
        with ``resample_topology``.
    faults:
        A ``sim.faults.FaultConfig``: the per-cell fault process runs in
        every decision window and the telemetry gains ``cells_down`` and
        ``reattach_events``.  Defaults to ``params.faults``; ``0`` forces
        it off.
    mesh, ue_axis:
        Shard the UE axis of the episode engine over the ``ue_axis`` axes
        of a ``core.distributed.Mesh`` (``episode_fns(mesh=)``).  The
        sharded program spans the ranks, so the batch surfaces
        (``reset_batch`` / ``step_batch`` / ``step_autoreset_batch``)
        raise: batch over seeds or shard over UEs, not both.
    """

    def __init__(self, params: Optional[CRRM_parameters] = None, *,
                 scenario: Optional[str] = None,
                 scenario_overrides: Optional[dict] = None,
                 episode_tti: int = 200, tti_per_step: int = 20,
                 per_tti_fading: bool = False,
                 resample_topology: bool = False, reward_fn=None,
                 radio_mode: Optional[str] = None,
                 telemetry: bool = False, churn=None, faults=None,
                 mesh=None, ue_axis=("ue",), device=None, draws=None,
                 sim=None):
        if sum(x is not None for x in (params, scenario, sim)) != 1:
            raise ValueError("pass exactly one of params=, scenario= or "
                             "sim=")
        if scenario is not None:
            from repro_torch.sim.scenarios import make_scenario
            params = make_scenario(scenario, **(scenario_overrides or {}))
        elif scenario_overrides:
            raise ValueError("scenario_overrides requires scenario=")
        if episode_tti < 1 or tti_per_step < 1:
            raise ValueError("episode_tti and tti_per_step must be >= 1")
        if churn is not None and resample_topology:
            raise ValueError(
                "churn= is incompatible with resample_topology=True: a "
                "resampled reset rebuilds EpisodeStatic per topology draw "
                "while churn carries its fading leaf in the state; run "
                "churn on the fixed construction-time topology")
        self.scenario = scenario
        self.episode_tti = int(episode_tti)
        self.tti_per_step = int(tti_per_step)
        self.resample_topology = bool(resample_topology)
        self.sim = CRRM(params, device=device) if sim is None else sim
        self.device = self.sim.device
        self.params = self.sim.params
        self.n_ues, self.n_cells = self.sim.n_ues, self.sim.n_cells
        self.n_subbands = self.params.n_subbands
        self._reward_fn = reward_fn or buffer_aware_reward
        self._draws = draws or Draws
        self.telemetry = bool(telemetry)
        self.churn, self.faults, self.mesh = churn, faults, mesh
        self._fns = self.sim.episode_fns(per_tti_fading=per_tti_fading,
                                         radio_mode=radio_mode,
                                         telemetry=self.telemetry,
                                         churn=churn, faults=faults,
                                         mesh=mesh, ue_axis=ue_axis)
        self._static = self.sim.episode_static()
        self._radio_static = self.sim.radio_static()
        # the reset template: PF EWMA seeded at the stationary alpha-fair
        # point, empty HARQ processes, attachment-serving, t=0
        self._state0 = self.sim.init_episode_state()
        if churn is not None:
            self._state0 = seed_churn_state(
                self._state0, self._static, self.params,
                per_tti_fading=per_tti_fading)

    # ------------------------------------------------------------- actions
    @property
    def action_shape(self) -> tuple:
        """(n_cells, n_subbands): per-cell/subband tx power in watts."""
        return (self.n_cells, self.n_subbands)

    @property
    def max_cell_power_W(self) -> float:
        """Per-cell power budget in watts, also the per-(cell, subband)
        action bound; :meth:`step` scales down any action whose per-cell
        total exceeds it."""
        return float(self.params.power_W)

    def uniform_action(self):
        """The baseline plan: every cell splits its budget evenly."""
        return torch.full(self.action_shape,
                          self.params.power_W / self.n_subbands,
                          dtype=torch.float32, device=self.device)

    def _expand_action(self, action):
        return expand_action(self.params, torch.as_tensor(
            action, dtype=torch.float32, device=self.device))

    # ---------------------------------------------------------------- core
    def _seed(self, seed):
        return torch.as_tensor(seed, dtype=torch.int64, device=self.device)

    def _resampled_reset(self, seed):
        """Draw a topology from ``seed`` and run the radio chain on it."""
        p = self.params
        draws = self._draws(int(seed), self.device)
        U = draws.topology(self.n_ues, p.extent_m, p.h_ut_m)
        cfg = self._radio_static.cfg
        if p.rayleigh_fading:
            fad = draws.topology_fading(cfg, self.n_ues, self.n_cells)
        else:
            fad = radio.unit_fading(cfg, self.n_ues, self.n_cells,
                                    device=self.device)
        out = radio.radio_forward(self._radio_static, U, fad=fad)
        static = self._static._replace(se=out.se, cqi=out.cqi, a=out.a,
                                       fad=fad)
        # seed the PF EWMA at this topology's stationary alpha-fair point
        pf0 = stationary_served_tput(p, self.n_cells, out.se, out.cqi,
                                     out.a, self._state0.backlog)
        ep = self._state0._replace(U=U, seed=self._seed(seed), pf_avg=pf0,
                                   serving=out.a)
        return TopoEnvState(ep=ep, static=static)

    def reset(self, seed):
        """Start one episode: ``(state, EnvObs)`` for this seed.

        Default: the construction-time template with this episode's seed,
        which drives traffic, HARQ and per-TTI fading.  With
        ``resample_topology=True`` the UE field and fading are redrawn from
        the seed and the radio chain is recomputed here.
        """
        if self.resample_topology:
            state = self._resampled_reset(seed)
            backlog = state.ep.backlog
        else:
            state = self._state0._replace(seed=self._seed(seed))
            backlog = state.backlog
        obs = EnvObs(tput=torch.zeros((self.n_ues,), dtype=torch.float32,
                                      device=self.device),
                     backlog=backlog)
        return state, obs

    def step(self, state, action=None, fairness_p=None):
        """Hold ``action`` for ``tti_per_step`` TTIs; observe and score.

        ``action`` is a (n_cells, n_subbands) power matrix (None keeps the
        construction-time power plan); ``fairness_p`` a scalar overriding
        the PF alpha-fairness exponent for the window (None keeps
        ``params.fairness_p``).  Returns ``(state, EnvObs, reward, done)``;
        constructed with ``telemetry=True`` a fifth element is appended:
        ``{"telemetry": Telemetry, "reward_components": dict}``.
        """
        with annotate("crrm.env.step"):
            return self._step(state, action, fairness_p)

    def _step(self, state, action, fairness_p):
        if self.resample_topology:
            ep, static = state.ep, state.static
        else:
            ep, static = state, self._static
        power = None if action is None else self._expand_action(action)
        draws = self._draws(int(ep.seed), self.device)
        ep, tput, *telem = self._fns.rollout(static, ep, self.tti_per_step,
                                             draws, power, fairness_p)
        return self._scored(ep, static, tput, telem, self._reward_fn)

    def _scored(self, ep, static, tput, telem, reward_fn):
        """``(state, obs, reward, done[, info])`` after a decision window:
        ``tput`` is the rollout's (.., n_tti, n_ues) throughput, ``telem``
        its telemetry in a list (empty when off), ``reward_fn(obs)`` the
        reward (one per env along a batch)."""
        with annotate("crrm.env.score"):
            obs = EnvObs(tput=tput.mean(dim=-2), backlog=ep.backlog)
            reward = reward_fn(obs)
            done = ep.t >= self.episode_tti
            if self.resample_topology:
                state = TopoEnvState(ep=ep, static=static)
            else:
                state = ep
            if self.telemetry:
                info = {"telemetry": telem[0],
                        "reward_components": self._components(obs,
                                                              telem[0])}
                return state, obs, reward, done, info
            return state, obs, reward, done

    def _components(self, obs, telem):
        """:func:`reward_components`, one env at a time along a batch."""
        if obs.tput.dim() == 1:
            return reward_components(obs, telem, self.params.tti_s)
        per_env = [reward_components(env_slice(obs, b), env_slice(telem, b),
                                     self.params.tti_s)
                   for b in range(obs.tput.shape[0])]
        return {k: torch.stack([c[k] for c in per_env]) for k in per_env[0]}

    def step_autoreset(self, state, action=None, reset_seed=None,
                       fairness_p=None):
        """:meth:`step`, restarting a finished episode from ``reset_seed``.

        Both branches are computed and every leaf of the returned state is
        ``torch.where(done, fresh, stepped)``: no control flow on ``done``,
        as in :meth:`step_autoreset_batch`.  The *returned* obs/reward/done
        (and info) are the pre-reset ones; only the carried state jumps.
        Requires ``resample_topology=False``.
        """
        if self.resample_topology:
            raise ValueError(
                "step_autoreset requires resample_topology=False: the "
                "reset would recompute the radio chain at every episode "
                "boundary; drive resampled episodes with explicit reset() "
                "calls instead")
        if reset_seed is None:
            raise ValueError("step_autoreset needs reset_seed= (the seed "
                             "of the replacement episode)")
        with annotate("crrm.env.step"):
            out = self._step(state, action, fairness_p)
            state, done = out[0], out[3]
            with annotate("crrm.env.reset"):
                fresh = _fresh_like(self.reset(reset_seed)[0], state)
                state = type(state)(*(
                    None if new is None else torch.where(done, new, old)
                    for new, old in zip(fresh, state)))
        return (state,) + out[1:]

    # ------------------------------------------------------------- batched
    def _no_mesh(self):
        if self.mesh is not None:
            raise ValueError(
                "batched env surfaces (reset_batch/step_batch/"
                "step_autoreset_batch) are unsupported under mesh=: the "
                "UE-sharded program already spans the ranks; batch over "
                "seeds OR shard over UEs, not both")

    def reset_batch(self, seeds):
        """B episodes from B seeds: ``(states, EnvObs)`` with every leaf
        leading with B -- the stack of ``reset(seed_b)``.  With
        ``resample_topology`` each seed owns its UE field."""
        self._no_mesh()
        outs = [self.reset(int(s)) for s in _seeds(seeds)]
        return _stack([o[0] for o in outs]), _stack([o[1] for o in outs])

    def step_batch(self, states, actions=None, fairness_p=None):
        """Advance B episodes, optionally under B actions ((B, n_cells,
        n_subbands)) and B ``fairness_p`` scalars: row b is ``step`` of
        env b.  Each env's radio side runs on its own draws; the MAC runs
        batched.  Returns ``(states, EnvObs, reward (B,), done (B,)[,
        info])``."""
        with annotate("crrm.env.step"):
            return self._step_batch(states, actions, fairness_p)

    def _step_batch(self, states, actions, fairness_p):
        self._no_mesh()
        if self.resample_topology:
            ep, static = states.ep, states.static
        else:
            ep, static = states, self._static
        power = None if actions is None else self._expand_action(actions)
        draws = [self._draws(s, self.device) for s in ep.seed.tolist()]
        ep, tput, *telem = self._fns.rollout(static, ep, self.tti_per_step,
                                             draws, power, fairness_p)
        return self._scored(ep, static, tput, telem, lambda obs: torch.stack(
            [self._reward_fn(env_slice(obs, b))
             for b in range(tput.shape[0])]))

    def step_autoreset_batch(self, states, actions, reset_seeds,
                             fairness_p=None):
        """Batched :meth:`step_autoreset`: env b restarts from
        ``reset_seeds[b]`` when it finishes, the others run on (each keeps
        its own TTI counter).  Requires ``resample_topology=False``."""
        if self.resample_topology:
            raise ValueError(
                "step_autoreset_batch requires resample_topology=False: "
                "the reset would recompute the radio chain at every "
                "episode boundary; drive resampled episodes with explicit "
                "reset_batch() calls instead")
        with annotate("crrm.env.step"):
            out = self._step_batch(states, actions, fairness_p)
            states, done = out[0], out[3]
            with annotate("crrm.env.reset"):
                fresh = _fresh_like(self.reset_batch(reset_seeds)[0], states)
                states = type(states)(*(
                    None if new is None else torch.where(
                        done.reshape((-1,) + (1,) * (new.dim() - 1)), new,
                        old)
                    for new, old in zip(fresh, states)))
        return (states,) + out[1:]


def _fresh_like(fresh, state):
    """A reset state with the fault leaf the stepped one carries: all-UP,
    what the engine seeds a fault-free reset with at its first step."""
    if fresh.cell_state is None and state.cell_state is not None:
        fresh = fresh._replace(cell_state=torch.zeros_like(state.cell_state))
    return fresh


def _seeds(seeds):
    """A batch of seeds as Python ints."""
    if isinstance(seeds, torch.Tensor):
        return seeds.tolist()
    return [int(s) for s in seeds]


def _stack(items):
    """Stack NamedTuples (nested ones too) leaf by leaf along a new axis 0;
    ``None`` stays ``None``."""
    first = items[0]
    if first is None:
        return None
    if isinstance(first, tuple):
        return type(first)(*(_stack(list(leaves)) for leaves in zip(*items)))
    return torch.stack(items)

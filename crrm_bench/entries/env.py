"""``env``: ``CrrmEnv.step_autoreset`` with one power action a step drawn
from the seed, each step synchronised as an agent reads its observation and
reward.

``correct`` holds the window's last step, and its last step that ended an
episode, to the reference's env step from the program's input state: the
returned state (after a reset, the fresh episode), the observation, the
reward, ``done`` and the telemetry (numbers defined in
:mod:`crrm_bench.harness.check`)."""
from __future__ import annotations

import torch

from crrm_bench.harness import check
from crrm_bench.harness.entry import Base, leaves, ref_start, start
from crrm_bench.reference import env as ref_env
from crrm_bench.reference.engine import Reference


class Entry(Base):
    """The RL loop: ``step_autoreset`` with a power action a step."""

    def setup(self):
        from repro_torch.core.params import CRRM_parameters
        from repro_torch.env import CrrmEnv
        tr = self.traffic
        self.env = CrrmEnv(CRRM_parameters(**self.params),
                           tti_per_step=self.tti_per_call,
                           episode_tti=int(tr["episode_tti"]),
                           telemetry=True, device=self.device)
        self.fns = self.env._fns
        e = self.env
        self.start = start(e._static, e._state0)
        # the actions: each cell's per-subband power, uniform in
        # [lo, 1] x its even share of the budget, drawn from the seed
        g = torch.Generator(device=self.device)
        g.manual_seed(self.seed)
        n_act = int(tr["action_pool"])
        u = torch.rand((n_act,) + e.action_shape, generator=g,
                       device=self.device)
        lo = float(tr["action_low"])
        self.actions = (lo + (1.0 - lo) * u) * (e.params.power_W
                                                / e.n_subbands)
        self.n_calls = 0
        self.episode = 0
        self.state, _ = e.reset(self._episode_seed(0))
        self.last = self.last_done = None

    def _episode_seed(self, k: int) -> int:
        return (self.seed * 1_000_003 + k) % (1 << 62)

    def call(self):
        i = self.n_calls
        act = self.actions[i % self.actions.shape[0]]
        reset_seed = self._episode_seed(self.episode + 1)
        s_in = self.state
        out = self.env.step_autoreset(s_in, act, reset_seed=reset_seed)
        state, obs, reward, done, info = out
        self._finite(obs.tput)
        done = bool(done)                    # the agent reads it
        self.n_calls += 1
        rec = (s_in, act, reset_seed, out)
        self.last = rec
        if done:
            self.episode += 1
            self.last_done = rec
        self.state = state

    def _record(self, rec):
        s_in, act, reset_seed, (state, obs, reward, done, info) = rec
        return {"s_in": leaves(s_in), "seed": int(s_in.seed),
                "action": act.clone(),
                "reset_seed": reset_seed, "s_out": leaves(state),
                "obs_tput": obs.tput.clone(), "backlog": obs.backlog.clone(),
                "reward": float(reward), "done": bool(done),
                "telem": info["telemetry"]}

    def program_outputs(self) -> dict:
        steps = [self._record(r) for r in (self.last, self.last_done)
                 if r is not None]
        res = {"start": self.start, "steps": steps}
        del self.env, self.fns, self.state, self.last, self.last_done
        return res

    def reference_outputs(self, prog: dict, dtype) -> dict:
        ref = Reference(self.params, self.device, dtype)
        su = ref.setup()
        tr = self.traffic
        steps = []
        for rec in prog["steps"]:
            steps.append(ref_env.step_autoreset(
                ref, su, rec["s_in"], rec["seed"], rec["action"],
                rec["reset_seed"],
                int(tr["episode_tti"]), self.tti_per_call))
        return {"start": ref_start(su), "steps": steps}


def _telem_sums(tel) -> dict:
    return {k: float(check.f64(v).sum()) for k, v in tel._asdict().items()
            if v is not None and k != "dirty_rows"}


def numbers(p: dict, r: dict) -> dict:
    out = check.start_numbers(p["start"], r["start"])
    obs = reward = tel = state = 0.0
    for ps, rs in zip(p["steps"], r["steps"]):
        obs = max(obs, check.off_share(ps["obs_tput"], rs["obs_tput"]))
        reward = max(reward, abs(ps["reward"] - rs["reward"]))
        tp, tr = _telem_sums(ps["telem"]), _telem_sums(rs["telem"])
        tel = max([tel] + [check.rel_gap(tp[k], v) for k, v in tr.items()])
        n_off = float(check.pos_off(ps["s_out"]["U"],
                                    rs["s_out"]["U"]).sum())
        for k, v in rs["s_out"].items():
            if k != "U":
                n_off += int(check.off(ps["s_out"][k], v).sum())
        n_off += int(check.off(ps["backlog"], rs["backlog"]).sum())
        n_off += int(ps["done"] != rs["done"])
        state = max(state, n_off)
    out.update(obs_off_share=obs, reward_gap=reward, telem_rel_gap=tel,
               state_off=state)
    return out

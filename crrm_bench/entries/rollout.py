"""``rollout``: ``CRRM(...).episode_fns(inc_backend=...).rollout(static,
state, n, draws)``, called again and again with the state threaded through,
each call synchronised; a traffic file's ``faults`` runs it under a
``FaultConfig``.

``correct`` holds the window's last call to the reference, which follows it
from the program's own input state: its carried state leaf by leaf, its
per-UE throughputs and, under faults, the serving cells (numbers defined in
:mod:`crrm_bench.harness.check`)."""
from __future__ import annotations

from crrm_bench.harness import check
from crrm_bench.harness.entry import Base, leaves, ref_start, start
from crrm_bench.reference.engine import Reference
from crrm_bench.reference.faults import FaultConfig as RefFaultConfig


class Entry(Base):
    """The TTI engine's rollout, with the state threaded through."""

    def _faults(self, cls):
        f = self.traffic.get("faults")
        return None if f is None else cls(**f)

    def setup(self):
        from repro_torch.core.crrm import CRRM
        from repro_torch.core.params import CRRM_parameters
        from repro_torch.mac.engine import Draws
        from repro_torch.sim.faults import FaultConfig
        faults = self._faults(FaultConfig)
        self.sim = CRRM(CRRM_parameters(**self.params, faults=faults),
                        device=self.device)
        self.fns = self.episode_fns()
        self.static = self.sim.episode_static()
        self.state = self.sim.init_episode_state()
        self.draws = Draws(self.seed, self.device)
        self.start = start(self.static, self.state)
        self.last = None

    def episode_fns(self):
        return self.sim.episode_fns(
            inc_backend=self.traffic.get("inc_backend", "auto"))

    def call(self):
        self.last = None
        s_in = self.state
        out, tput = self.fns.rollout(self.static, s_in, self.tti_per_call,
                                     self.draws)
        self._finite(tput)
        self.state = out
        self.last = (s_in, out, tput)

    def program_outputs(self) -> dict:
        s_in, out, tput = self.last
        res = {"start": self.start, "s_in": leaves(s_in),
               "s_out": leaves(out), "tput": tput}
        del self.sim, self.fns, self.static, self.state, self.last
        return res

    def reference_outputs(self, prog: dict, dtype) -> dict:
        ref = Reference(self.params, self.device, dtype,
                        faults=self._faults(RefFaultConfig))
        su = ref.setup()
        state = {k: v.clone() for k, v in prog["s_in"].items()}
        s_out, tput, _ = ref.rollout(su, state, self.tti_per_call, self.seed)
        return {"start": ref_start(su), "s_out": s_out, "tput": tput}


def numbers(p: dict, r: dict) -> dict:
    out = check.start_numbers(p["start"], r["start"])
    out.update(check.state_numbers(p["s_out"], r["s_out"],
                                   apart=("serving",) if "cell_state"
                                   in r["s_out"] else ()))
    out["tput_off_share"] = check.off_share(p["tput"], r["tput"])
    if "cell_state" in r["s_out"]:
        out["serving_off"] = check.count_off(p["s_out"].get("serving"),
                                             r["s_out"]["serving"])
    return out

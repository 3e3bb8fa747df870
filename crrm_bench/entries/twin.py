"""``twin``: the guarded ``TwinServer.step_chunk`` under churn, which
checkpoints into ``TMPDIR`` on its cadence.

``correct`` holds the window's last chunk to the reference as a rollout's
(:mod:`crrm_bench.entries.rollout`), and its KPI summary besides."""
from __future__ import annotations

import shutil
import tempfile

import torch

from crrm_bench.entries import rollout
from crrm_bench.harness import check
from crrm_bench.harness.entry import leaves, ref_start, start
from crrm_bench.reference.engine import Reference
from crrm_bench.reference.mobility import ChurnConfig as RefChurnConfig
from crrm_bench.reference.telemetry import stack
from crrm_bench.reference.telemetry import summarize as ref_summarize


class Entry(rollout.Entry):
    """The guarded twin server under churn, checkpointing into TMPDIR."""

    def setup(self):
        from repro_torch.core.crrm import CRRM
        from repro_torch.core.params import CRRM_parameters
        from repro_torch.robust.watchdog import WatchdogConfig
        from repro_torch.sim.mobility import ChurnConfig
        from repro_torch.twin.server import TwinServer
        tr = self.traffic
        self.sim = CRRM(CRRM_parameters(**self.params), device=self.device)
        self.ckpt_dir = tempfile.mkdtemp(prefix="crrm_bench_ckpt_")
        wd = WatchdogConfig(**tr["watchdog"])
        self.srv = TwinServer(self.sim, ChurnConfig(**tr["churn"]),
                              chunk_tti=self.tti_per_call,
                              ckpt_dir=self.ckpt_dir,
                              keep_last=int(tr["keep_last"]),
                              inc_backend=tr.get("inc_backend", "auto"),
                              watchdog=wd)
        self.fns = self.srv.fns
        self.start = start(self.srv.static, self.srv.state)
        self.last = None
        self.dirty = torch.zeros((), dtype=torch.int64, device=self.device)

    def warmup(self):
        super().warmup()
        self.dirty.zero_()

    def call(self):
        self.last = None
        s_in = self.srv.state
        kpis = self.srv.step_chunk()
        self._finite(self.srv.last_tput)
        self.dirty += self.srv.last_telem.dirty_rows.sum()
        self.last = (s_in, self.srv.state, self.srv.last_tput, kpis)

    def dirty_rows(self, calls: int) -> float:
        return float(self.dirty)

    def program_outputs(self) -> dict:
        s_in, out, tput, kpis = self.last
        res = {"start": self.start, "s_in": leaves(s_in),
               "s_out": leaves(out), "tput": tput, "kpis": kpis}
        del self.srv, self.sim, self.fns, self.last
        return res

    def reference_outputs(self, prog: dict, dtype) -> dict:
        tr = self.traffic
        ref = Reference(self.params, self.device, dtype,
                        churn=RefChurnConfig(**tr["churn"]))
        su = ref.setup()
        state = {k: v.clone() for k, v in prog["s_in"].items()}
        fair = torch.tensor(float(self.params.get("fairness_p", 0.0)),
                            dtype=torch.float32, device=self.device)
        s_out, tput, telems = ref.rollout(su, state, self.tti_per_call,
                                          self.seed, action=su.static.P,
                                          fairness_p=fair)
        kpis = ref_summarize(stack(telems), tti_s=ref.p.tti_s)
        kpis["t"] = float(s_out["t"])
        kpis["active_ues"] = float(s_out["active"].sum())
        return {"start": ref_start(su),
                "s_out": s_out, "tput": tput, "kpis": kpis}

    def close(self):
        shutil.rmtree(getattr(self, "ckpt_dir", ""), ignore_errors=True)


def numbers(p: dict, r: dict) -> dict:
    out = rollout.numbers(p, r)
    out["kpi_rel_gap"] = max(check.rel_gap(p["kpis"][k], v)
                             for k, v in r["kpis"].items())
    return out

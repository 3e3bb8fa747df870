"""The reference's gradient checks of the relaxed engine, as data.

Two checks, each on the reference's own inputs (the scenario's drop, the
initial state of ``PRNGKey(0)``, that key's traffic and HARQ draws, and a
direction of ``PRNGKey(1)``), kept in ``tests/data/relax_<kind>_<scenario>.npz``
so that they run on the port wherever there is no JAX -- on the card
(``chip_smoke.py`` phase 13 and ``tests/test_torch_cuda.py``):

* ``fd`` -- ``tests/test_rl.py::test_grad_matches_finite_differences``:
  the directional derivative through an 8-TTI relaxed rollout at 12 UEs
  against central differences, best over four eps, <= 1e-3
  (:func:`fd_check`, on ``dense_urban`` and ``handover_stress``);
* ``diffopt`` -- ``rl.diffopt.make_power_objective`` at ``u = 0`` on
  ``dense_urban``'s preset width (200 UEs), with the reference's value,
  ``jax.grad`` and central differences stored beside the inputs
  (:func:`diffopt_check`), over two horizons (:data:`HORIZONS`):
  ``optimize_power_plan``'s defaults, 4 segments x 10 TTIs, and the first
  2 TTIs as 2 segments.  Only the short one is a contract.  From the third
  TTI on, a drained backlog leaves a residue of one float32 ulp (2**-10
  bits on a 12 000-bit packet) in one program and none in the other,
  wherever the soft SE's last bit differs (torch's and XLA's exp, or the
  reference's compiled and eager programs); the UE then keeps competing
  for its cell's PF share, and the two trajectories part (ROADMAP
  queue 3).

This module imports neither JAX nor the JAX package;
``tests/make_relax_fixture.py`` writes the files from the reference, and
``tests/test_torch_relax_grad.py`` holds the committed files equal to it.
"""
from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from repro_torch import convert
from repro_torch.env.crrm_env import expand_action
from repro_torch.mac.engine import Draws
from repro_torch.rl import diffopt
from repro_torch.sim.radio import RelaxConfig
from repro_torch.sim.scenarios import make_scenario

DATA = Path(__file__).resolve().parent / "data"
SCENARIOS = ("dense_urban", "handover_stress")
N_UES, N_TTI = 12, 8
EPS = (1e-1, 3e-2, 1e-2, 3e-3)        # the reference test's four eps
ROOTS = ("U", "C", "P", "boresight", "fading", "buffer")
#: the diffopt check's preset width ...
DIFFOPT = dict(scenario="dense_urban", n_ues=200)
#: ... and its horizons, (n_segments, tti_per_segment): optimize_power_plan's
#: defaults, and the TTIs that both programs share bit for bit
HORIZONS = {"full": (4, 10), "held": (2, 1)}


def path(scenario: str, kind: str = "fd") -> Path:
    return DATA / f"relax_{kind}_{scenario}.npz"


class FixtureDraws(Draws):
    """The reference's traffic and HARQ draws of a check's TTIs; the
    checks' scenarios draw nothing else (static geometry and fading)."""

    def __init__(self, data: dict, device):
        super().__init__(0, device)
        self.arrivals = torch.as_tensor(data["arrivals"], device=device)
        self.harq_u = torch.as_tensor(data["harq_u"], device=device)

    def traffic(self, t, traffic_step):
        return self.arrivals[t]

    def harq_uniform(self, t, n):
        return self.harq_u[t]

    def _seeded(self, lineage, offset):
        raise AssertionError("the fixture holds only traffic and HARQ draws")


def read(scenario: str, kind: str = "fd") -> dict:
    with np.load(path(scenario, kind)) as f:
        return {k: f[k] for k in f.files}


def load(scenario: str, n_ues: int, data: dict, device,
         direction: str = "direction"):
    """``(sim, static, state, draws, direction)`` of a check on
    ``device``: the port ``CRRM`` on the reference's drop."""
    p = make_scenario(scenario, n_ues=n_ues)
    fields = {k: getattr(p, k) for k in p.__dataclass_fields__}
    roots = {k: data[f"root_{k}"] for k in ROOTS}
    sim = convert.crrm_from_reference(fields, roots, device)
    part = lambda prefix: {k[len(prefix) + 1:]: v for k, v in data.items()
                           if k.startswith(prefix + "_")}
    static = convert.episode_static(part("static"), device)
    state = convert.episode_state(part("state"), device)
    return (sim, static, state, FixtureDraws(data, device),
            torch.as_tensor(data[direction], device=device))


def fd_errors(f, x0, v, gv):
    """Relative error of ``gv`` against central differences of ``f`` at
    ``x0`` along ``v``, one per eps of :data:`EPS`."""
    errs = []
    with torch.no_grad():
        for eps in EPS:
            fd = float(f(x0 + eps * v) - f(x0 - eps * v)) / (2 * eps)
            errs.append(abs(gv - fd) / max(abs(fd), 1e-12))
    return errs


def fd_check(scenario: str, device, relax=RelaxConfig()):
    """The reference test's check on the port: ``(g.v, best relative
    error over EPS, [error per eps])`` of the autograd directional
    derivative against central differences at the uniform power grid."""
    sim, static, state, draws, v = load(scenario, N_UES, read(scenario),
                                        device)
    p = sim.params
    fns = sim.episode_fns(radio_mode="dense", relax=relax)

    def f(P):
        return fns.rollout(static, state, N_TTI, draws, P)[1].mean() / 1e6

    P0 = expand_action(p, torch.full((sim.n_cells, p.n_subbands),
                                     p.power_W / p.n_subbands,
                                     device=device))
    P = P0.clone().requires_grad_(True)
    (g,) = torch.autograd.grad(f(P), P)
    if not bool(torch.isfinite(g).all()):
        raise AssertionError(f"{scenario}: non-finite gradient")
    v = v / v.norm() * P0.norm()
    gv = float((g * v).sum())
    errs = fd_errors(f, P0, v, gv)
    return gv, min(errs), errs


def diffopt_check(device, horizon: str = "held"):
    """The power objective at ``u = 0`` over ``HORIZONS[horizon]`` on the
    port and in the reference: ``{"port": ..., "ref": ...}``, each a dict
    of the objective (``value``, Mbit/s), the gradient (``grad``), its
    derivative along the stored unit direction (``gv``) and the relative
    error of ``gv`` against central differences per eps (``fd_errs``).
    The port's objective is ``diffopt.make_power_objective``'s soft one on
    the reference's drop and draws."""
    data = read(DIFFOPT["scenario"], "diffopt")
    sim, _, state, draws, v = load(DIFFOPT["scenario"], DIFFOPT["n_ues"],
                                   data, device, f"{horizon}_direction")
    own = sim.init_episode_state(0)
    for k, x in state._asdict().items():
        if x is not None and k != "seed" and not torch.allclose(
                getattr(own, k).to(x.dtype), x, rtol=1e-6, atol=0.0):
            raise AssertionError(f"diffopt fixture: the port's initial "
                                 f"{k} is not the reference's")
    soft, _ = diffopt.make_power_objective(
        sim, tti_per_segment=HORIZONS[horizon][1], draws=draws)
    u0 = torch.zeros(v.shape, dtype=torch.float32, device=device)
    leaf = u0.clone().requires_grad_(True)
    value = soft(leaf)
    (g,) = torch.autograd.grad(value, leaf)
    gv = float((g * v).sum())
    port = dict(value=float(value.detach()), grad=g.cpu().numpy(), gv=gv,
                fd_errs=fd_errors(soft, u0, v, gv))
    ref = {k: data[f"{horizon}_ref_{k}"] for k in port}
    ref.update(value=float(ref["value"]), gv=float(ref["gv"]),
               fd_errs=[float(e) for e in ref["fd_errs"]])
    return {"port": port, "ref": ref}

"""The LM half of the port's dry-run (``repro_torch.launch.dryrun``)
against the reference's, exactly, for every LM config and SHAPES cell on
the pod and multipod meshes:

* the analytic fields -- ``param_counts``, ``analytic_flops``,
  ``analytic_flops_fwd``, ``analytic_bytes`` and its breakdown,
  ``model_flops`` -- against the reference's own functions
  (``_param_counts``, ``_model_flops``, ``analysis.flops``), which need no
  lowering;
* the strategy and accumulation its ``_lower_cell`` picks, read by
  stopping it at its first step past the choice;
* the per-device bytes, against the same sum over the reference's spec
  trees (``AbstractMesh``, Auto axes): train cells the params and
  Adafactor's state, serve cells the bfloat16 params and the cache;
* the HLO fields absent and named as absent, never 0.
"""
import dataclasses
import os
import types

import jax
import numpy as np
import pytest

from lm_train_parity import one_thread  # noqa: F401  (autouse)
from parallel_parity import meshes, strategy  # noqa: F401
from repro.analysis import flops as j_flops
from repro.configs import LM_ARCH_IDS
from repro.configs import get_config as j_config
from repro.models.registry import SHAPES
from repro.models.registry import input_specs as j_input_specs
from repro.models.registry import make_arch as j_arch
from repro.models.registry import shape_applicable
from repro.parallel import mesh as j_mesh
from repro.parallel import sharding as j_shd
from repro.train import optim as j_optim
from repro_torch.launch import dryrun


@pytest.fixture(scope="module")
def rd():
    """``repro.launch.dryrun``; its import sets ``XLA_FLAGS``, put back."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("XLA_FLAGS", os.environ.get("XLA_FLAGS", ""))
        import repro.launch.dryrun as rd
    return rd


class _Stop(Exception):
    pass


def ref_plan(rd, cfg, shape, jm, monkeypatch):
    """The strategy (and accumulation) the reference's ``_lower_cell``
    picks for a cell, stopped before it lowers anything."""
    seen = {}
    mesh = types.SimpleNamespace(shape=dict(jm.shape),
                                 axis_names=jm.axis_names,
                                 devices=np.empty(jm.size))
    monkeypatch.setattr(j_mesh, "set_strategy",
                        lambda m: seen.setdefault("strategy", m))

    def stop(*a, **k):
        raise _Stop

    def jit_step(arch, opt, m, batch_shapes, accum_steps):
        seen["accum_steps"] = accum_steps
        raise _Stop
    monkeypatch.setattr("repro.parallel.act_sharding.set_mesh_shardings",
                        lambda m: None)
    monkeypatch.setattr(rd, "jit_train_step", jit_step)
    monkeypatch.setattr(rd, "input_specs",
                        lambda *a: (_ for _ in ()).throw(_Stop())
                        if SHAPES[shape]["kind"] != "train"
                        else j_input_specs(*a))
    with pytest.raises(_Stop):
        rd._lower_cell(cfg, shape, mesh)
    return seen


def ref_bytes(cfg, shape, jm, mode):
    """Per-device bytes of the cell's state from the reference's spec
    trees."""
    j_mesh.set_strategy(mode)

    def total(tree, specs):
        flat = jax.tree_util.tree_leaves(tree)
        sp = jax.tree_util.tree_leaves(
            specs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
        out = 0
        for x, s in zip(flat, sp):
            div = 1
            for a in s:
                if a is not None:
                    div *= j_mesh.axis_size(jm, a)
            out += int(np.prod(x.shape)) * x.dtype.itemsize // div
        return out
    kind = SHAPES[shape]["kind"]
    if kind == "train":
        arch = j_arch(cfg)
        p = jax.eval_shape(lambda: arch.init(jax.random.PRNGKey(0)))
        o = jax.eval_shape(
            lambda: j_optim.adafactor(j_optim.constant_lr(1e-4)).init(p))
        return {"params": total(p, j_shd.infer_param_specs(p, jm)),
                "opt": total(o, j_shd.infer_param_specs(o, jm))}
    cfg = dataclasses.replace(cfg, param_dtype="bfloat16")
    arch = j_arch(cfg)
    p = jax.eval_shape(lambda: arch.init(jax.random.PRNGKey(0)))
    batch, cache = j_input_specs(cfg, shape)
    if cache is None:
        S = SHAPES[shape]["seq_len"]
        cache = jax.eval_shape(lambda pp, b: arch.prefill(pp, b, S), p,
                               batch)[1]
    return {"params": total(p, j_shd.infer_param_specs(p, jm)),
            "cache": total(cache, j_shd.cache_specs(cfg, cache, jm))}


@pytest.mark.parametrize("arch_id", LM_ARCH_IDS)
def test_lm_cells(arch_id, rd, tmp_path, monkeypatch, strategy):
    cfg = j_config(arch_id)
    counts = rd._param_counts(cfg)
    for name in ("pod", "multipod"):
        jm, tm = meshes(name)
        for shape in SHAPES:
            art = dryrun.run_lm_cell(arch_id, shape, tm, name,
                                     str(tmp_path))
            if not shape_applicable(cfg, shape)[0]:
                assert art["skipped"] and art["reason"] == \
                    shape_applicable(cfg, shape)[1]
                continue
            fl = j_flops.step_flops(cfg, shape)
            by = j_flops.step_bytes(cfg, shape, counts["total"])
            assert art["param_counts"] == counts
            assert art["analytic_flops"] == fl["total"]
            assert art["analytic_flops_fwd"] == fl["fwd"]
            assert art["analytic_bytes"] == by["total"]
            assert art["analytic_bytes_breakdown"] == by
            assert art["model_flops"] == rd._model_flops(cfg, shape)
            with monkeypatch.context() as mp:
                plan = ref_plan(rd, cfg, shape, jm, mp)
            assert art["strategy"] == plan["strategy"], (arch_id, shape)
            assert art.get("accum_steps") == plan.get("accum_steps")
            want = ref_bytes(cfg, shape, jm, plan["strategy"])
            got = art["reckoned_bytes_per_device"]
            assert got == dict(want, total=sum(want.values())), \
                (arch_id, shape, name)
            for field in ("hlo_flops", "collective_wire_bytes",
                          "memory_analysis"):
                assert field not in art and field in art["absent"]["fields"]

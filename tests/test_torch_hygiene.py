"""The port stands alone: no JAX, no reference package, no silent CPU.

An ``ast`` scan of every module of ``src/repro_torch``, of ``chip_smoke.py``,
of the fixture loaders it reads (``tests/relax_fixture.py``,
``tests/lm_fixture.py``, ``tests/lm_train_fixture.py``) and of the mesh
ranks' module (``tests/torch_mesh.py``) finds no import of ``jax``,
``repro`` or ``msgpack``; a
fresh interpreter that imports every port module has not loaded ``jax``; the
entry points default to the card and raise without one.
"""
import ast
import os
import subprocess
import sys
from pathlib import Path

import jax  # noqa: F401  (the parity suites import both packages)
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"


def port_files():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py",
                                         ROOT / "tests" / "relax_fixture.py",
                                         ROOT / "tests" / "lm_fixture.py",
                                         ROOT / "tests" / "lm_train_fixture.py",
                                         ROOT / "tests" / "torch_mesh.py"]


def test_the_scan_covers_every_package_of_the_port():
    scanned = {p.relative_to(PORT).parts[0] for p in port_files()
               if PORT in p.parents}
    assert {"core", "sim", "mac", "kernels", "obs", "env", "train",
            "robust", "twin", "rl", "analysis", "configs", "launch",
            "models", "serve"} <= scanned
    names = module_names()
    for m in ("repro_torch.env.crrm_env", "repro_torch.env.gym_adapter",
              "repro_torch.obs.telemetry", "repro_torch.sim.scenarios",
              "repro_torch.sim.faults", "repro_torch.sim.shadowing",
              "repro_torch.kernels.pairwise_dist",
              "repro_torch.kernels.ref", "repro_torch.tree",
              "repro_torch.train.checkpoint", "repro_torch.robust.guard",
              "repro_torch.robust.watchdog", "repro_torch.robust.chaos",
              "repro_torch.twin.server", "repro_torch.train.optim",
              "repro_torch.rl", "repro_torch.rl.policy",
              "repro_torch.rl.rollout", "repro_torch.rl.ppo",
              "repro_torch.rl.diffopt", "repro_torch.core.distributed",
              "repro_torch.obs.profile", "repro_torch.obs.report",
              "repro_torch.analysis", "repro_torch.analysis.roofline",
              "repro_torch.configs", "repro_torch.configs.crrm_ppp",
              "repro_torch.launch.dryrun", "repro_torch.models.config",
              "repro_torch.models.layers", "repro_torch.models.attention",
              "repro_torch.models.flash", "repro_torch.models.moe",
              "repro_torch.models.mamba", "repro_torch.models.transformer",
              "repro_torch.models.registry", "repro_torch.serve.engine",
              "repro_torch.launch.serve", "repro_torch.configs.qwen1p5_0p5b",
              "repro_torch.configs.zamba2_1p2b", "repro_torch.models.encdec",
              "repro_torch.train.loss", "repro_torch.train.data",
              "repro_torch.train.step", "repro_torch.train.loop",
              "repro_torch.launch.train", "repro_torch.analysis.flops"):
        assert m in names, m


def module_names():
    return sorted(
        ".".join(("repro_torch",) + p.relative_to(PORT).with_suffix("").parts)
        .removesuffix(".__init__")
        for p in PORT.rglob("*.py"))


def imported_roots(path):
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


@pytest.mark.parametrize("path", port_files(), ids=lambda p: p.name)
def test_no_jax_or_reference_import(path):
    # msgpack too: the card's machine has none (checkpoints write JSON)
    bad = imported_roots(path) & {"jax", "jaxlib", "repro", "msgpack"}
    assert not bad, f"{path} imports {sorted(bad)}"


def test_importing_the_port_loads_no_jax():
    code = ("import importlib, sys\n"
            f"for m in {module_names()!r}:\n"
            "    importlib.import_module(m)\n"
            "assert 'jax' not in sys.modules, 'jax was imported'\n"
            "assert not any(k == 'repro' or k.startswith('repro.') "
            "for k in sys.modules)\n"
            "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_entry_points_default_to_the_card():
    from repro_torch import resolve_device
    from repro_torch.core.crrm import CRRM
    from repro_torch.core.params import CRRM_parameters
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        CRRM(CRRM_parameters(n_ues=4))
    from repro_torch.configs import get_config
    from repro_torch.models.registry import make_arch
    from repro_torch.serve.engine import ServeEngine
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServeEngine(make_arch(get_config("qwen1.5-0.5b", reduced=True)))
    from repro_torch.launch import train as launch_train
    with pytest.raises(RuntimeError, match="device='cpu'"):
        launch_train.main(["--reduced", "--steps", "1"])
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device(None)
    assert resolve_device("cpu").type == "cpu"


def test_fused_on_a_cuda_tensor_never_runs_the_plain_version(monkeypatch):
    """The wrapper sends CUDA tensors to the kernel launcher only: with the
    launcher replaced, the plain version must not be called."""
    from repro_torch.kernels import fused_sinr as fk

    class FakeCuda:
        device = torch.device("cuda")

    called = []
    monkeypatch.setattr(fk, "_launch", lambda *a, **k: called.append("k"))
    monkeypatch.setattr(fk, "fused_sinr_accumulate_plain",
                        lambda *a, **k: called.append("plain"))
    fk.fused_sinr_accumulate(FakeCuda(), None, None, None, pathgain_fn=None)
    assert called == ["k"]
    with pytest.raises(ValueError, match="CUDA or CPU"):
        class Meta:
            device = torch.device("meta")
        fk.fused_sinr_accumulate(Meta(), None, None, None, pathgain_fn=None)

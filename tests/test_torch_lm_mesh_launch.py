"""The repaired launcher: ``python -m repro_torch.launch.train`` trains
through the sharded step on a 1-rank ``(1, 1)`` mesh (``--mesh host``, the
default), as the reference's launcher does (``make_host_mesh(1, 1)``), so
it computes the layers on bfloat16-rounded weights.

Held to the reference's sharded loop on an Auto (1, 1) mesh (in the pytest
process: one device) with the launcher's own set-up: reduced
qwen1.5-0.5b, AdamW (weight decay 0.1) over ``warmup_cosine(3e-3,
max(steps // 20, 5), steps)``, ``SyntheticLM`` batch 4 x 32 from seed 0,
from the reference's initial state (step 0 of the checkpoint directory).
The launcher logs its last step, so it runs ``--steps k`` for k = 1..4
from the same start: the warm-up spans all four steps, so the schedule of
each is the reference's 4-step one.  Contract: each loss within rtol
1e-5; the port's unsharded loop misses it (checked in
``tests/test_torch_lm_mesh_train.py``).
"""
import shutil

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AxisType

import lm_mesh_parity as lmp
from lm_train_parity import one_thread  # noqa: F401  (autouse)
from repro.configs import get_config as j_config
from repro.models.registry import make_arch as j_arch
from repro.parallel import act_sharding as j_act
from repro.train import optim as j_optim
from repro.train.data import SyntheticLM as JSyntheticLM
from repro.train.loop import train as j_train
from repro_torch.launch import train as launch_train

STEPS, LR = 4, 3e-3
RUN = dict(arch="qwen1.5-0.5b", opt=("adamw", {}), lr=(LR, 5, STEPS),
           batch=(4, 32), steps=STEPS)


@pytest.fixture(scope="module")
def reference():
    cfg = j_config(RUN["arch"], reduced=True)
    mesh = jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2)
    opt = j_optim.adamw(j_optim.warmup_cosine(*RUN["lr"]))
    try:
        _, hist = j_train(j_arch(cfg), opt, mesh,
                          JSyntheticLM(cfg.vocab_size, 4, 32, seed=0),
                          steps=STEPS, log_every=1)
    finally:
        j_act.clear()
    return hist


def test_launcher_holds_the_reference_sharded_loop(tmp_path, reference):
    start = lmp.start_from_reference(RUN, tmp_path / "start")["dir"]
    got = []
    for k in range(1, STEPS + 1):
        d = tmp_path / f"run{k}"
        shutil.copytree(start, d)
        hist = launch_train.main(["--reduced", "--device", "cpu", "--steps",
                                  str(k), "--batch", "4", "--seq-len", "32",
                                  "--lr", str(LR), "--ckpt-dir", str(d)])
        got.append(hist[-1])
    assert not torch.distributed.is_initialized()
    np.testing.assert_allclose(got, reference, rtol=lmp.RTOL_4)

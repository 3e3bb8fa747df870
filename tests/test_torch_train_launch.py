"""The port's training loop under SIGTERM and its launcher, on reduced
qwen1.5-0.5b on the CPU: a SIGTERM mid-run saves the state ``train``
returns (bit for bit) and a resume goes on from it, the handler put back;
``launch.train.main`` trains on a 1-rank mesh (``--mesh host`` and
``host:1x2``, which falls back to the ranks there are), checkpoints,
resumes, runs each optimizer with accumulation, and refuses the families
whose inputs the token streams do not carry.  (The loop held to the
reference's: ``tests/test_torch_train_loop.py``; the launcher held to the
reference's sharded loop: ``tests/test_torch_lm_mesh_launch.py``.)
"""
import os
import signal

import numpy as np
import pytest
import torch

from lm_train_parity import one_thread  # noqa: F401  (autouse)
from repro_torch.configs import get_config
from repro_torch.launch import train as launch_train
from repro_torch.models.registry import make_arch
from repro_torch.train import checkpoint as ckpt
from repro_torch.train import optim
from repro_torch.train.data import SyntheticLM
from repro_torch.train.loop import train
from repro_torch.tree import flatten

ARCH = "qwen1.5-0.5b"


class SigtermAt:
    """A data source that sends this process SIGTERM when the prefetcher
    first asks for step ``at``."""

    def __init__(self, source, at):
        self.source, self.at, self.sent = source, at, False

    def batch_at(self, step):
        if step == self.at and not self.sent:
            self.sent = True
            os.kill(os.getpid(), signal.SIGTERM)
        return self.source.batch_at(step)


def test_sigterm_saves_and_resumes(tmp_path):
    d = tmp_path / "ckpt"
    cfg = get_config(ARCH, reduced=True)
    arch = make_arch(cfg)
    opt = optim.adamw(optim.warmup_cosine(3e-3, 5, 60))
    data = SyntheticLM(cfg.vocab_size, batch=4, seq_len=32, seed=0)
    before = signal.getsignal(signal.SIGTERM)
    state, _ = train(arch, opt, None, SigtermAt(data, 6), steps=40,
                     ckpt_dir=str(d), ckpt_every=100, log_every=5,
                     device="cpu")
    assert signal.getsignal(signal.SIGTERM) is before
    stopped = int(state["step"])
    assert 0 < stopped < 40 and ckpt.latest_step(str(d)) == stopped
    saved, extra = ckpt.restore(str(d), stopped, state)
    assert extra == {"train_step": stopped}
    for a, b in zip(flatten(saved)[1], flatten(state)[1]):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    state, _ = train(arch, opt, None, data, steps=stopped + 2,
                     ckpt_dir=str(d), log_every=5, device="cpu")
    assert int(state["step"]) == stopped + 2


def test_launch_train_main(tmp_path, capsys):
    d = str(tmp_path / "ckpt")
    argv = ["--reduced", "--device", "cpu", "--steps", "6", "--batch", "2",
            "--seq-len", "16", "--ckpt-dir", d, "--ckpt-every", "3"]
    hist = launch_train.main(argv)
    out = capsys.readouterr().out
    assert "# arch=qwen1.5-0.5b-reduced" in out
    assert "step,loss,accuracy,grad_norm,lr,tokens_per_s" in out
    assert len(hist) == 1 and np.isfinite(hist).all()
    assert ckpt.all_steps(d) == [3, 6]
    launch_train.main(argv[:4] + ["8"] + argv[5:])
    assert "# resumed from" in capsys.readouterr().out
    assert ckpt.latest_step(d) == 8
    # (1, 2) over one rank: the reference's fallback to (world, 1)
    hist = launch_train.main(["--reduced", "--device", "cpu", "--steps", "3",
                              "--batch", "2", "--seq-len", "16", "--mesh",
                              "host:1x2"])
    assert "mesh={'data': 1, 'model': 1}" in capsys.readouterr().out
    assert len(hist) == 1 and np.isfinite(hist).all()
    assert not torch.distributed.is_initialized()


@pytest.mark.parametrize("arch", ["seamless-m4t-large-v2", "qwen2-vl-72b"])
def test_launch_train_refuses_embedding_families(arch, capsys):
    with pytest.raises(SystemExit):
        launch_train.main(["--arch", arch, "--reduced", "--device", "cpu"])
    assert "frontend embeddings" in capsys.readouterr().err


@pytest.mark.parametrize("name", ["adafactor", "sgdm"])
def test_launch_train_other_optimizers(tmp_path, name):
    hist = launch_train.main(["--reduced", "--device", "cpu", "--steps",
                              "10", "--batch", "4", "--seq-len", "16",
                              "--optimizer", name, "--accum", "2",
                              "--no-resume"])
    assert len(hist) == 1 and np.isfinite(hist[0])

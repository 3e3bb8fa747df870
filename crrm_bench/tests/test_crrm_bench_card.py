"""On the card: one short run of each cell comes out correct, and the
bfloat16 control does not.  Run there with ``python -m pytest -m gpu
crrm_bench/tests``; skipped on a host without CUDA."""
import json
import subprocess
import sys

import pytest

from crrm_bench_toy import ROOT, manifest

CELLS = [w["name"] for w in manifest()["workloads"]]


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the benchmark measures the card")


def _run(script, *args):
    out = subprocess.run([sys.executable, str(ROOT / "crrm_bench" / script),
                          *args], capture_output=True, text=True,
                         timeout=600, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    return out.stdout.splitlines()


@pytest.mark.gpu
@pytest.mark.parametrize("cell", CELLS)
def test_cell_on_the_card(card, cell):
    res = json.loads(_run("run.py", "--workload", cell, "--seed",
                          "2147483701", "--seconds", "2", "--trace", "0")[-1])
    assert res["correct"] is True, res["check"]
    ctl = json.loads(_run("survey.py", "--workload", cell, "--seeds",
                          "2147483701", "--seconds", "2", "--control")[-1])
    assert ctl["numbers"]["correct"] is False

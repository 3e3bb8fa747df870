"""The control: the plain reference computed in bfloat16, put in the
program's place, comes out not correct under every cell's limits, while
the program comes out correct (at toy size on the CPU; on the card at the
cells' own size with ``crrm_bench/survey.py --control``)."""
import pytest

from crrm_bench_toy import manifest, result, toy_root

TOYS = ["toy_" + w["name"] for w in manifest()["workloads"]]


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return toy_root(tmp_path_factory.mktemp("toy"))


@pytest.mark.parametrize("workload", TOYS)
def test_program_correct_control_not(root, workload):
    assert result(root, workload, seed=21)["correct"] is True
    ctl = result(root, workload, seed=21, control=True)
    assert ctl["correct"] is False
    over = [k for k, v in ctl["check"].items()
            if not v["value"] <= v["limit"]]
    assert over, ctl["check"]

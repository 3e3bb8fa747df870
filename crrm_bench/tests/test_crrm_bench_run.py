"""Tiny CPU runs of the harness on toy cells added purely from new files:
the last line holds exactly the contract's keys (and ``check``, last)."""
import json

import pytest

from crrm_bench_toy import manifest, result, run, toy_root

TOYS = ["toy_" + w["name"] for w in manifest()["workloads"]]
KEYS = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return toy_root(tmp_path_factory.mktemp("toy"))


@pytest.mark.parametrize("workload", TOYS)
def test_untraced_last_line(root, workload):
    res = result(root, workload)
    assert list(res) == KEYS + ["check"]
    assert res["correct"] is True and res["failed"] == 0
    assert res["attempted"] >= 1
    e2e = {m["name"] for m in manifest()["end_to_end"]
           if "workloads" not in m or workload[4:] in m["workloads"]}
    assert set(res["metrics"]) == e2e
    assert set(res["device"]) == {"platform", "kind", "count",
                                  "memory_peak_bytes"}


def test_traced_last_line(root):
    res = result(root, "toy_uma1m_full", trace=1)
    assert list(res) == KEYS + ["breakdown", "check"]
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
    assert {"busy_s", "window_s"} <= set(res["device"])
    # a CPU trace has no device operations: every device reader is silent
    assert res["metrics"] == {}


def test_path_line_and_the_refusals(root, tmp_path):
    rc, lines = run(root, "toy_uma1m_full")
    path = json.loads(lines[0])["path"]
    assert path["route"]["inc_backend"] == "fused"
    assert path["ttis"] == 5 * path["calls"]
    (tmp_path / "BENCHMARK.json").write_text(
        (root / "BENCHMARK.json").read_text())
    rc, lines = run(tmp_path, "toy_uma1m_full")   # no program beside it
    assert rc != 0 and lines == []

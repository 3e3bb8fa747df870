"""The manifest resolves every file it names, and keeps to its contract."""
import json
import re

import pytest

from crrm_bench_toy import BENCH, ROOT, manifest

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
MAN = manifest()
WORKLOADS = [w["name"] for w in MAN["workloads"]]


def test_top_level_keys():
    assert set(MAN) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
    assert MAN["paths"] == ["crrm_bench"]
    assert MAN["command"] == ["python3", "crrm_bench/run.py"]
    assert 1 <= MAN["run_seconds"] <= 51
    assert len(json.dumps(MAN)) < 64 * 1024


@pytest.mark.parametrize("workload", WORKLOADS)
def test_workload_resolves_its_files(workload):
    from crrm_bench.harness import manifest as m
    cell = m.cell(ROOT, workload)
    kind = m.entry_kind(BENCH, cell.traffic["entry"])
    assert callable(kind.Entry) and callable(kind.numbers)
    assert cell.config["CRRM_parameters"]["n_ues"] > 0
    assert cell.limits and all("limit" in v for v in cell.limits.values())
    assert {x["name"] for x in cell.end_to_end} >= {"setup_s", "ms_per_tti"}
    assert cell.per_layer
    for metric in cell.end_to_end + cell.per_layer:
        assert callable(m.reader(BENCH, metric["name"]))


def test_names_units_and_bounds():
    metrics = MAN["end_to_end"] + MAN["per_layer"]
    names = ([c["name"] for c in MAN["configs"]] + WORKLOADS
             + [x["name"] for x in metrics])
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    e2e = {x["name"] for x in MAN["end_to_end"]}
    for x in MAN["end_to_end"]:
        assert UNIT.match(x["unit"]) and x["better"] in ("lower", "higher")
        assert 0.01 <= x["bound"] <= 0.25
        assert x["source"] in ("host_clock", "device_trace")
    for x in MAN["per_layer"]:
        assert UNIT.match(x["unit"]) and x["moves"] in e2e
        assert set(x.get("workloads", WORKLOADS)) <= set(WORKLOADS)
    pairs = [(w["config"], w["traffic"]) for w in MAN["workloads"]]
    assert len(pairs) == len(set(pairs))
    for w in MAN["workloads"]:
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200


@pytest.mark.parametrize("config", [c["name"] for c in MAN["configs"]])
def test_config_file_names_itself(config):
    entry = {c["name"]: c for c in MAN["configs"]}[config]
    conf = json.loads((ROOT / entry["file"]).read_text())
    assert conf["name"] == config
    assert entry["file"].startswith("crrm_bench/")
    assert conf["reduced"] == entry["reduced"]
    assert len(conf["source"]) <= 200

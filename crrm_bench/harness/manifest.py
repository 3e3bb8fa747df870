"""The benchmark's data: ``BENCHMARK.json`` and the files it names.

Everything that belongs to one configuration, one traffic mix, one cell's
correctness limits or one metric is a file of its own, found by
its name:

* ``configs/<config>.json``   -- the deployment (``CRRM_parameters``);
* ``traffic/<traffic>.json``  -- the entry kind and its parameters;
* ``limits/<workload>.json``  -- the numbers ``correct`` compares, each
  with its limit and the readings it was set from;
* ``entries/<kind>.py``       -- an entry kind that traffic files name: how
  the program is driven and which numbers ``correct`` compares;
* ``metrics/<metric>.py``     -- the reader of one metric, end-to-end or
  per-layer.

A cell is added by adding files and a ``workloads`` entry; no file of the
harness changes.
"""
from __future__ import annotations

import importlib
import importlib.util
import json
import re
from pathlib import Path
from typing import Any, NamedTuple

BENCH_DIR = Path(__file__).resolve().parents[1]


class Cell(NamedTuple):
    """One workload of the manifest with everything it names."""

    name: str
    chips: int
    config: dict          # the configuration file, parsed
    traffic: dict         # the traffic file, parsed
    limits: dict          # {number: {"limit": x, ...}}
    end_to_end: list      # the manifest's end-to-end metrics of this cell
    per_layer: list       # the manifest's per-layer metrics of this cell
    bench_dir: Path


def _read(path: Path) -> Any:
    with open(path) as fh:
        return json.load(fh)


def load_manifest(root: Path) -> dict:
    return _read(Path(root) / "BENCHMARK.json")


def _applies(metric: dict, cell: str, reported: set) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    return metric.get("moves", metric["name"]) in reported


def cell(root: Path, name: str, bench_dir: Path = BENCH_DIR) -> Cell:
    """The workload ``name`` of the manifest at ``root``."""
    man = load_manifest(root)
    work = {w["name"]: w for w in man["workloads"]}
    if name not in work:
        raise KeyError(f"no workload {name!r} in {Path(root) / 'BENCHMARK.json'}"
                       f"; known: {sorted(work)}")
    w = work[name]
    configs = {c["name"]: c for c in man["configs"]}
    conf = _read(Path(root) / configs[w["config"]]["file"])
    traffic = _read(bench_dir / "traffic" / f"{w['traffic']}.json")
    limits = {k: v for k, v in
              _read(bench_dir / "limits" / f"{name}.json").items()
              if isinstance(v, dict)}
    e2e = [m for m in man["end_to_end"]
           if "workloads" not in m or name in m["workloads"]]
    reported = {m["name"] for m in e2e}
    per_layer = [m for m in man["per_layer"] if _applies(m, name, reported)]
    return Cell(name=name, chips=int(w["chips"]), config=conf,
                traffic=traffic, limits=limits, end_to_end=e2e,
                per_layer=per_layer, bench_dir=bench_dir)


def reader(bench_dir: Path, metric: str):
    """The ``read(trace, ctx)`` function of ``metrics/<metric>.py``; the
    trace is ``None`` in an untraced run."""
    path = Path(bench_dir) / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        f"crrm_bench_metric_{metric.replace('.', '_').replace('-', '_')}",
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def entry_kind(bench_dir: Path, kind: str):
    """The module ``entries/<kind>.py``, with its ``Entry`` and
    ``numbers``."""
    path = Path(bench_dir) / "entries" / f"{kind}.py"
    if not re.fullmatch(r"[a-z][a-z0-9_]*", kind) or not path.is_file():
        raise KeyError(f"no entry kind {kind!r} at {path}")
    return importlib.import_module(f"crrm_bench.entries.{kind}")

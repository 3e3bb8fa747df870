"""Toy cells for the harness's CPU tests, added purely from new files.

:func:`toy_root` copies ``crrm_bench/`` into a temporary checkout, links
the program's ``src/`` beside it, and adds, for each cell of the real
manifest, a toy configuration (the cell's own with a few hundred UEs), a
toy traffic file (the cell's own with short calls) and a copy of the
cell's limits, plus a ``BENCHMARK.json`` that lists the toys, and the
cells over several ranks of :data:`TOY_MESH`: ``rollout_mesh`` on the toy
``crrm_uma_1m``, its traffic file written into the copy alone.  No file of
the harness is edited.

The ``worker_hook`` functions below break a worker rank of such a cell.
"""
from __future__ import annotations

import contextlib
import io
import json
import os
import shutil
import sys
import time
import types
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "crrm_bench"
for _p in (str(ROOT / "src"), str(ROOT)):
    if _p not in sys.path:
        sys.path.insert(0, _p)

#: the toy's sizes: UEs, and cells for the omni configurations
TOY_UES = 400
TOY_CELLS_OMNI = 7
#: toy cells over several ranks, gloo ranks on the CPU: name -> chips
TOY_MESH = {"toy_uma1m_mesh2": 2, "toy_uma1m_mesh4": 4}
#: the real cell whose traffic and limits the toy mesh cells take
MESH_OF = "uma1m_full"


def manifest() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def _toy_config(conf: dict) -> dict:
    conf = json.loads(json.dumps(conf))
    p = conf["CRRM_parameters"]
    scale = TOY_UES / p["n_ues"]
    p["n_ues"] = TOY_UES
    if p.get("n_sectors", 1) == 1:
        p["n_cells"] = TOY_CELLS_OMNI
    conf["name"] = "toy_" + conf["name"]
    conf["scale"] = scale
    return conf


def _toy_traffic(tr: dict, scale: float) -> dict:
    tr = json.loads(json.dumps(tr))
    tr["warmup_calls"] = 1
    tr["trace_calls"] = 2
    if tr["entry"] == "env":
        tr["episode_tti"] = 2 * tr["tti_per_call"]
    else:
        tr["tti_per_call"] = 5
    if "churn" in tr:
        ch = tr["churn"]
        ch["arrival_rate_hz"] *= scale
        ch["max_arrivals_per_tti"] = max(
            2, round(ch["max_arrivals_per_tti"] * scale))
        tr["watchdog"]["ckpt_every_chunks"] = 2
    return tr


def toy_root(tmp: Path) -> Path:
    """A checkout in ``tmp`` whose manifest lists one toy per real cell,
    named ``toy_<cell>``."""
    tmp = Path(tmp)
    shutil.copytree(BENCH, tmp / "crrm_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    (tmp / "src").symlink_to(ROOT / "src")
    real = manifest()
    files = {c["name"]: c["file"] for c in real["configs"]}
    toys = json.loads(json.dumps(real))
    toys["configs"], toys["workloads"] = [], []
    scale = {}
    for c in real["configs"]:
        conf = _toy_config(json.loads((ROOT / files[c["name"]]).read_text()))
        f = f"crrm_bench/configs/toy_{c['name']}.json"
        (tmp / f).write_text(json.dumps(conf))
        toys["configs"].append(dict(c, name=conf["name"], file=f))
        scale[c["name"]] = conf["scale"]
    for w in real["workloads"]:
        tr = json.loads((BENCH / "traffic" / f"{w['traffic']}.json")
                        .read_text())
        tr = _toy_traffic(tr, scale[w["config"]])
        name = "toy_" + w["name"]
        (tmp / "crrm_bench" / "traffic" / f"toy_{w['traffic']}.json"
         ).write_text(json.dumps(tr))
        shutil.copy(BENCH / "limits" / f"{w['name']}.json",
                    tmp / "crrm_bench" / "limits" / f"{name}.json")
        toys["workloads"].append(dict(w, name=name,
                                      config="toy_" + w["config"],
                                      traffic=f"toy_{w['traffic']}"))
    mesh = {w["name"]: w for w in real["workloads"]}[MESH_OF]
    tr = json.loads((BENCH / "traffic" / f"{mesh['traffic']}.json")
                    .read_text())
    tr = dict(_toy_traffic(tr, scale[mesh["config"]]), entry="rollout_mesh")
    (tmp / "crrm_bench" / "traffic" / "toy_rollout_mesh.json").write_text(
        json.dumps(tr))
    for name, chips in TOY_MESH.items():
        shutil.copy(BENCH / "limits" / f"{MESH_OF}.json",
                    tmp / "crrm_bench" / "limits" / f"{name}.json")
        toys["workloads"].append(dict(
            mesh, name=name, config="toy_" + mesh["config"],
            traffic="toy_rollout_mesh", chips=chips,
            why=f"the toy rollout on a UE mesh of {chips} gloo ranks"))
    for m in toys["end_to_end"] + toys["per_layer"]:
        if "workloads" in m:
            m["workloads"] = ["toy_" + n for n in m["workloads"]]
    (tmp / "BENCHMARK.json").write_text(json.dumps(toys, indent=1))
    return tmp


@contextlib.contextmanager
def jax_set_aside():
    """Take the modules of JAX and the JAX package, which other tests of a
    shared test process may have loaded, out of ``sys.modules`` for the
    block, and put them back after it: the run inside still looks for
    them, and finds what it loads itself."""
    from crrm_bench.harness.main import FORBIDDEN
    aside = {k: v for k, v in sys.modules.items()
             if k.split(".")[0] in FORBIDDEN}
    for k in aside:
        del sys.modules[k]
    try:
        yield
    finally:
        sys.modules.update(aside)


def run(root: Path, workload: str, seed: int = 3, trace: int = 0,
        control: bool = False, worker_hook=None):
    """One CPU run of the harness: ``(exit code, stdout lines)``."""
    from crrm_bench.harness import main
    buf = io.StringIO()
    with jax_set_aside():
        rc = main.run(["--workload", workload, "--seed", str(seed),
                       "--seconds", "0.01", "--trace", str(trace)],
                      root=root, device="cpu", t_start=time.perf_counter(),
                      out=buf, control=control, worker_hook=worker_hook)
    return rc, buf.getvalue().splitlines()


def result(root: Path, workload: str, **kw) -> dict:
    rc, lines = run(root, workload, **kw)
    assert rc == 0, lines
    return json.loads(lines[-1])


# -- worker hooks: each runs first in a worker rank (``functools.partial``
# binds the directory where the worker notes its process id) -------------
def _own_part(x, ax):
    return x.clone()


def leave_out_psum(rank):
    """The exchange between ranks left out: ``psum`` returns the rank's own
    part (rank 0, the test's own process, is patched by the test)."""
    from repro_torch.core import distributed
    distributed.psum = _own_part


def _note_pid(pid_dir):
    Path(pid_dir, f"{os.getpid()}.pid").touch()


def raise_at_setup(pid_dir, rank):
    _note_pid(pid_dir)
    from crrm_bench.entries import rollout_mesh

    def setup(self):
        raise RuntimeError(f"rank {rank} fails at set-up")
    rollout_mesh.Entry.setup = setup


def stall(pid_dir, rank):
    _note_pid(pid_dir)
    from crrm_bench.entries import rollout_mesh
    rollout_mesh.Entry.call = lambda self: time.sleep(3600)


def load_jax(pid_dir, rank):
    _note_pid(pid_dir)
    sys.modules["jax"] = types.ModuleType("jax")

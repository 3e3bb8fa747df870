"""Cells over several ranks, on gloo ranks on the CPU.  The toy
``rollout_mesh`` cells of 2 and 4 ranks come out correct and read as one
result from rank 0: a ``device.ranks`` entry per rank and the fullest
rank's peak.  A worker rank that raises at set-up, stalls past its
deadline or loads JAX fails the run: a non-zero exit, no result line and no
process left alive."""
import functools
import json
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

import crrm_bench_toy as toy


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return toy.toy_root(tmp_path_factory.mktemp("toy"))


def peak_by_rank(rank):
    """A worker reports ``rank`` MiB of peak memory (the CPU has none)."""
    from crrm_bench.harness import ranks
    report = ranks.report

    def planted(*a, **kw):
        return dict(report(*a, **kw), memory_peak_bytes=rank << 20)
    ranks.report = planted


@pytest.mark.parametrize("workload,trace", [("toy_uma1m_mesh2", 1),
                                            ("toy_uma1m_mesh4", 0)])
def test_ranks_read_as_one_result(root, workload, trace):
    chips = toy.TOY_MESH[workload]
    rc, lines = toy.run(root, workload, seed=7, trace=trace,
                        worker_hook=peak_by_rank)
    assert rc == 0, lines
    assert [json.loads(x).keys() for x in lines][0] == {"path"}
    res = json.loads(lines[-1])
    assert res["correct"] is True and res["failed"] == 0, res["check"]
    dev = res["device"]
    assert dev["count"] == chips
    assert [r["rank"] for r in dev["ranks"]] == list(range(chips))
    assert dev["memory_peak_bytes"] == max(
        r["memory_peak_bytes"] for r in dev["ranks"]) == (chips - 1) << 20
    path = json.loads(lines[0])["path"]
    assert [r["calls"] for r in path["ranks"]] == [res["attempted"]] * chips
    if trace:
        assert all({"busy_s", "window_s"} <= set(r) for r in dev["ranks"])


RUN = """
import functools, sys, time
from pathlib import Path
sys.path[:0] = [{tests!r}]
import crrm_bench_toy as toy
from crrm_bench.harness import main, ranks


def noting_pids(init):
    def wrapped(self, *a, **kw):
        init(self, *a, **kw)
        for p in self.procs:
            Path({pids!r}, f"{{p.pid}}.pid").touch()
    return wrapped


if __name__ == "__main__":
    ranks.SETUP_ALLOWANCE_S = {allowance!r}
    ranks.Team.__init__ = noting_pids(ranks.Team.__init__)
    root = toy.toy_root({root!r})
    hook = functools.partial(getattr(toy, {fault!r}), {pids!r})
    sys.exit(main.run(["--workload", "toy_uma1m_mesh2", "--seed", "9",
                       "--seconds", "0.01", "--trace", "0"], root=root,
                      device="cpu", t_start=time.perf_counter(),
                      worker_hook=hook))
"""


def _alive(pid: int) -> bool:
    try:
        stat = Path(f"/proc/{pid}/stat").read_text()
    except FileNotFoundError:
        return False
    return stat.rsplit(")", 1)[1].split()[0] != "Z"


def _none_alive(pids: Path) -> bool:
    workers = [int(p.stem) for p in pids.glob("*.pid")]
    return bool(workers) and not any(_alive(pid) for pid in workers)


@pytest.mark.parametrize("fault,allowance,says", [
    ("raise_at_setup", 240.0, "fails at set-up"),
    ("stall", 2.0, "still running")])
def test_a_failing_worker_fails_the_run(tmp_path, fault, allowance, says):
    """Rank 0 may be waiting in a collective, so the run ends by the watch
    over the workers, from its own process: here a process of the test's,
    which notes each worker's process id as it starts it (a worker may be
    killed at the deadline before its own hook has run)."""
    pids = tmp_path / "pids"
    pids.mkdir()
    script = tmp_path / "run_toy.py"
    script.write_text(textwrap.dedent(RUN.format(
        tests=str(toy.BENCH / "tests"), allowance=allowance,
        root=str(tmp_path / "toy"), fault=fault, pids=str(pids))))
    out = subprocess.run([sys.executable, str(script)], capture_output=True,
                         text=True, timeout=120, cwd=tmp_path)
    assert out.returncode != 0, out.stdout[-2000:]
    assert '"correct"' not in out.stdout
    assert says in out.stderr, out.stderr[-3000:]
    assert _none_alive(pids)


def test_a_worker_that_loads_jax_fails_the_run(root, tmp_path):
    rc, lines = toy.run(root, "toy_uma1m_mesh2", seed=9,
                        worker_hook=functools.partial(toy.load_jax,
                                                      str(tmp_path)))
    assert rc != 0 and not any('"correct"' in x for x in lines)
    assert _none_alive(tmp_path)

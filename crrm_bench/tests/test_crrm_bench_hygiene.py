"""Nothing the harness or the reference imports is JAX or the JAX package
(top-level names compared whole), and the reference imports nothing of the
program."""
import ast
import subprocess
import sys
import textwrap

from crrm_bench_toy import BENCH, ROOT


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_reference_imports_nothing_of_the_program():
    for path in sorted((BENCH / "reference").glob("*.py")):
        tops = {name.split(".")[0] for name in _imports(path)}
        assert not tops & {"repro_torch", "repro", "jax", "jaxlib", "flax"}, \
            path


def test_no_source_imports_jax_or_the_jax_package():
    for path in sorted(BENCH.rglob("*.py")):
        tops = {name.split(".")[0] for name in _imports(path)}
        assert not tops & {"repro", "jax", "jaxlib", "flax"}, path


def test_a_run_loads_no_jax(tmp_path):
    code = textwrap.dedent(f"""
        import sys
        sys.path[:0] = [{str(ROOT / 'crrm_bench' / 'tests')!r}]
        from crrm_bench_toy import toy_root, result
        root = toy_root({str(tmp_path)!r})
        for w in ("toy_uma1m_full", "toy_urban100k_env"):
            result(root, w)
        from crrm_bench.harness import main
        assert main.forbidden_modules() == [], main.forbidden_modules()
        assert "repro_torch" in sys.modules
        # a cell on one chip joins no process group and starts no process
        import multiprocessing, threading
        import torch.distributed as dist
        assert "crrm_bench.harness.ranks" not in sys.modules
        assert not dist.is_initialized()
        assert multiprocessing.active_children() == []
        assert threading.active_count() == 1
        # a run that finds JAX loaded fails and prints no result
        import io, time, types
        sys.modules["jax"] = types.ModuleType("jax")
        buf = io.StringIO()
        rc = main.run(["--workload", "toy_uma1m_full", "--seed", "3",
                       "--seconds", "0.01", "--trace", "0"], root=root,
                      device="cpu", t_start=time.perf_counter(), out=buf)
        assert rc != 0 and "correct" not in buf.getvalue(), rc
        print("clean")
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=240, cwd=tmp_path)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().endswith("clean")

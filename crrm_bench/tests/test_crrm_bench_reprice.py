"""The ``reprice_cells_roofline`` reader on hand-built traces."""
import pytest

from crrm_bench_toy import BENCH  # noqa: F401  (puts the harness on the path)
from crrm_bench.harness import manifest, trace

UMA_1M = {"n_ues": 1_000_000, "n_cells": 127, "n_subbands": 1}


def _trace(*kernels):
    dev = [("kern_a", 0.0, 10.0)] + list(kernels)
    return trace.Trace(device=dev, host=[], window_s=1e-3)


def test_one_pass_over_the_million_ue_field():
    read = manifest.reader(BENCH, "reprice_cells_roofline")
    ctx = {"ttis": 2, "params": UMA_1M}
    # 516 MB at 3.35 TB/s is 154.03 us; two launches of 200 us each
    tr = _trace(("void (anonymous namespace)::reprice_cells_kernel<1>("
                 "Args)", 20.0, 220.0),
                ("void (anonymous namespace)::reprice_cells_kernel<1>("
                 "Args)", 300.0, 500.0))
    assert read(tr, ctx) == pytest.approx(100 * 516e6 / 3.35e12 / 200e-6)
    assert read(tr, ctx) == pytest.approx(77.015, rel=1e-4)


def test_frequency_chunks_count_in_the_written_sinr():
    read = manifest.reader(BENCH, "reprice_cells_roofline")
    ctx = {"ttis": 1, "params": dict(UMA_1M, n_subbands=2, n_rb_subbands=2)}
    tr = _trace(("reprice_cells_kernel<4>", 0.0, 100.0))
    nbytes = 4 * 127e6 + 4e6 + 16e6
    assert read(tr, ctx) == pytest.approx(100 * nbytes / 3.35e12 / 100e-6)


@pytest.mark.parametrize("params,kernels", [
    (UMA_1M, []),                                      # no launch
    (dict(UMA_1M, rayleigh_fading=True),
     [("reprice_cells_kernel<1>", 0.0, 100.0)]),       # faded: not counted
])
def test_silent_without_a_launch_or_on_a_faded_field(params, kernels):
    read = manifest.reader(BENCH, "reprice_cells_roofline")
    assert read(_trace(*kernels), {"ttis": 1, "params": params}) is None

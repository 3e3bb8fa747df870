"""The frozen yardsticks and the trace reader, on counts made by hand."""
import pytest

from crrm_bench_toy import BENCH  # noqa: F401  (puts the harness on the path)
from crrm_bench.harness import manifest, trace, yardstick


def test_fused_sinr_work_at_the_cells_shapes():
    # 100 000 dirty rows x 127 cells, K = 1, UMa, omni, an int32 row index:
    # per link 11 (distance) + 36 (UMa, power) + 6 (one chunk) + 1 (argmax)
    ops, nbytes = yardstick.fused_sinr_work(100_000, 127, 1, "UMa", 1,
                                            idx_bytes=400_000)
    assert ops == 100_000 * 127 * 54 == 685_800_000
    # in: rows 3 x 4 B, cells 3 x 4 B, power 4 B, boresight 4 B, index;
    # out: per row 2 K + 2 floats
    assert nbytes == (4 * (300_000 + 381 + 127 + 127) + 400_000
                      + 4 * (200_000 + 200_000)) == 3_202_540
    bound = yardstick.bound_s(ops, nbytes)
    assert bound == pytest.approx(685_800_000 / 67e12)      # operations
    assert bound == pytest.approx(10.2358e-6, rel=1e-4)


def test_sector_and_fading_terms():
    ops, nbytes = yardstick.fused_sinr_work(10, 21, 4, "UMi", 3,
                                            fad_floats=10 * 21 * 4)
    assert ops == 10 * 21 * (11 + 36 + 24 + 1 + 12)
    assert nbytes == 4 * (30 + 63 + 84 + 21) + 4 * 840 + 4 * (80 + 20)


def _trace():
    dev = [("kern_a", 0.0, 10.0), ("kern_a", 5.0, 20.0),
           ("Memcpy HtoD", 30.0, 40.0), ("void fused_sinr_kernel<1>", 50.0,
                                         70.0)]
    host = [("aten::outer", 0.0, 100.0), ("aten::inner", 20.0, 31.0)]
    return trace.Trace(device=dev, host=host, window_s=100e-6)


def test_union_and_busy():
    tr = _trace()
    assert trace.union_us([(s, e) for _, s, e in tr.device]) == 50.0
    assert trace.busy_s(tr) == pytest.approx(50e-6)
    assert len(tr.kernels()) == 3


def test_breakdown_names_ops_and_gaps():
    b = trace.breakdown(_trace())
    assert b["device_ops"][0] == ["kern_a", pytest.approx(25e-6)]
    gaps = dict(b["idle_gaps"])
    assert gaps["aten::inner"] == pytest.approx(10e-6)     # 20..30
    assert gaps["aten::outer"] == pytest.approx(10e-6)     # 40..50


@pytest.mark.parametrize("metric,value", [
    ("device_idle_pct", 50.0), ("device_ms_per_tti", 0.045 / 2),
    ("launches_per_tti", 1.5)])
def test_readers(metric, value):
    read = manifest.reader(BENCH, metric)
    ctx = {"ttis": 2, "params": {}, "fused_sinr_rows": 0.0,
           "fused_sinr_launches": 0}
    assert read(_trace(), ctx) == pytest.approx(value)


def test_roofline_reader():
    read = manifest.reader(BENCH, "fused_sinr_roofline")
    params = {"n_cells": 127, "pathloss_model_name": "UMa"}
    ctx = {"ttis": 1, "params": params, "fused_sinr_rows": 100_000.0,
           "fused_sinr_launches": 1}
    # 20 us of kernel against the 10.2358 us bound
    assert read(_trace(), ctx) == pytest.approx(51.179, rel=1e-4)
    ctx["fused_sinr_launches"] = 0
    assert read(_trace(), ctx) is None          # no launch: no reading
    empty = trace.Trace(device=[], host=[], window_s=1.0)
    assert read(empty, dict(ctx, fused_sinr_launches=1)) is None

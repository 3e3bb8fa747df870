"""``ServeEngine(arch, mesh)`` against the reference's ``ServeEngine`` on
the same meshes, and the port's HLO text parser against the reference's.

The reference's engine runs in one subprocess that forces 4 host devices
and builds Auto (1, 1) and (1, 2) meshes (``tests/lm_mesh_parity.py``,
``serve_on_meshes``; its eager prefill lays yi-6b's sequence-sharded
cache out otherwise than its jitted decode takes it, so the subprocess
reshards the prefill's caches, an exact copy): reduced qwen1.5-0.5b (KV
heads on ``model``) and yi-6b (1 KV head: ``head_dim`` and the cache's
sequence on ``model``), 2 slots, ``max_len`` 64, the reference test's two
requests.  The port's engine serves the reference engine's own params
(saved by the subprocess, through ``convert.lm_params``): (1, 1) on a
1-rank gloo group in the pytest process, (1, 2) on two gloo ranks.  Held
under ``tests/lm_fixture.py``'s contract: logits within 1e-3 while a
slot's inputs agree, tokens exact off counted near ties.  Each rank of
(1, 2) holds half of every TP-sharded weight and its attention computes
2 of the 4 heads.

The same subprocess compiles a jitted function with a psum and a
reduce-scatter inside a scan on the forced devices; the port's
``analysis.hlo.collective_stats`` of its text equals the reference's.
The MoE config: ``tests/test_torch_serve_mesh_moe.py``.
"""
import pytest

import lm_mesh_parity as lmp
from lm_train_parity import one_thread  # noqa: F401  (autouse)
from repro_torch.analysis import hlo

ARCHS = ["qwen1.5-0.5b", "yi-6b"]


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    return lmp.serve_on_meshes(ARCHS, tmp_path_factory)


@pytest.mark.parametrize("shape", lmp.SERVE_MESHES)
@pytest.mark.parametrize("arch", ARCHS)
def test_engine_holds_the_reference_s(served, arch, shape):
    ref, _, port = served
    lmp.hold_served(ref, port, arch, shape)


@pytest.mark.parametrize("arch", ARCHS)
def test_each_rank_holds_its_model_block(served, arch):
    blocks = lmp.hold_blocks(served[2], arch)
    if arch == "yi-6b":
        assert blocks["layers/attn/wk"] == (2, 128, 1, 16)


def test_hlo_collective_stats_equal_the_reference_s(served):
    ref, d, _ = served
    text = (d / "module.hlo").read_text()
    got = hlo.collective_stats(text)
    want = ref["hlo"]
    assert got.counts == want["counts"]
    assert got.counts.get("all-reduce", 0) >= 1
    assert got.bytes_by_kind == want["bytes_by_kind"]
    assert got.total_wire_bytes == want["total_wire_bytes"]
    # the scan's trip count multiplies the loop body's bytes
    assert max(hlo._computation_multipliers(text).values()) == 3
    assert hlo.shape_bytes("(f32[4,2]{1,0}, bf16[3])") == 38

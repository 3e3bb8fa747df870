"""Prefill and decode steps computed tensor-parallel on the ``model``
axis, on sharded caches: reduced configs on (1, 2) and (2, 2) meshes of
gloo ranks (``tests/torch_mesh.py``, job ``tp_models``) against the port's
unsharded model on the same weights (the reference's params through
``convert.lm_params``).

Prefill of 2 x 5 tokens and 3 decode steps on caches from
``init_cache(mesh=)`` -- qwen1.5-0.5b's KV heads on ``model``, yi-6b's
sequence on ``model`` (1 KV head; decode combines the ranks' softmax
statistics: a pmax of the row max, psums of the exp-sum and the context),
yi's int8 cache, granite-moe-1b-a400m's -- every step's logits and the
final caches (assembled by their specs), and the query heads each
attention call computed: n_heads / 2 (all heads in a decode over the
sequence-sharded cache).

Contract (float32): within rtol 1e-5 of each tensor's largest magnitude;
int8 caches within one quantisation step.
"""
import numpy as np
import pytest

import lm_mesh_parity as lmp
from lm_mesh_parity import TP_MESHES as MESHES
from lm_mesh_parity import tp_close as close
from lm_train_parity import one_thread  # noqa: F401  (autouse)

#: case -> (arch, config overrides, kind)
CASES = {
    "serve_qwen": ("qwen1.5-0.5b", {}, "serve"),
    "serve_yi": ("yi-6b", {}, "serve"),
    "serve_yi_int8": ("yi-6b", {"kv_cache_dtype": "int8"}, "serve"),
    "serve_granite": ("granite-moe-1b-a400m", {}, "serve"),
}
N_HEADS = 4                       # every reduced config's


def _inputs(cfg, kind, rng):
    return {"batch": {"tokens": rng.integers(0, cfg.vocab_size, (2, 5))
                      .astype(np.int32)},
            "feed": rng.integers(0, cfg.vocab_size, (2, 3)).astype(
                np.int32),
            "max_len": 16}


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    return lmp.tp_run("tp_models", lmp.tp_cases(CASES, _inputs),
                      tmp_path_factory)


@pytest.mark.parametrize("shape", MESHES)
@pytest.mark.parametrize("name", sorted(CASES))
def test_prefill_and_decode(results, shape, name):
    for rank, out in enumerate(results[shape]):
        want, got = out[name]["logits"]
        for t, (w, g) in enumerate(zip(want, got)):
            close(g, w, f"{name} rank {rank}: step {t} logits")
        for key, (w, g, spec) in out[name]["caches"].items():
            if "int8" in name and key in ("k", "v"):
                assert np.abs(g - w).max() <= 1, (name, key)
            else:
                close(g, w, f"{name} rank {rank}: cache {key}")
        seq_sharded = out[name]["caches"]["k"][2][2] == "model"
        assert seq_sharded == name.startswith("serve_yi")
        # prefill on the rank's heads; a decode over the sequence-sharded
        # cache on every head
        assert out[name]["heads"] == ([N_HEADS // 2, N_HEADS]
                                      if seq_sharded else [N_HEADS // 2])

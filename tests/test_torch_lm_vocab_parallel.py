"""The vocab-parallel cross entropy (``train.loss.chunked_ce_sums`` on the
head's ``parallel.tp.VocabBlock``): with the vocab on ``model`` each rank
keeps its vocab columns of the logits, and each sequence chunk combines
them exactly -- a pmax of the row max, one psum of the exp-sum and the
gold logit, a pmin of the winning global index -- with no (b, s, V)
assembly.  On (1, 2) and (1, 4) meshes of gloo ranks
(``tests/torch_mesh.py``, job ``vocab_ce``) against the unsharded
``chunked_ce_sums`` on the whole head: the untied head (vocab columns on
``model``) and the tied table (vocab rows), two chunks, a mask with
zeros, the default z-loss and a large one.

Held: the NLL sum (loss and z-loss) and the gradients of the features and
of the head's weight (the rank's block of the whole gradient) within rtol
1e-5 of each tensor's largest magnitude; the hit count and the token
count exactly.  The ``ties`` case has integer logits whose row maximum
sits on several ranks for many tokens: the global argmax takes the lowest
index, as ``torch.argmax`` does on the whole row, so the hit count is
exact there too.
"""
import numpy as np
import pytest

import torch_mesh
from lm_mesh_parity import tp_close as close
from lm_train_parity import one_thread  # noqa: F401  (autouse)

MESHES = [(1, 2), (1, 4)]
B, S, D, V = 2, 16, 32, 64


def _case(seed, tied=False, ties=False, z_loss=1e-4):
    rng = np.random.default_rng(seed)
    if ties:
        feats = rng.integers(-1, 2, (B, S, D)).astype(np.float32)
        w = rng.integers(-1, 2, (V, D) if tied else (D, V)).astype(
            np.float32)
        logits = feats @ (w.T if tied else w)
        # most labels the lowest maximal index (a tie broken otherwise
        # loses their hits), the others random
        labels = np.where(rng.random((B, S)) < 0.75,
                          np.argmax(logits, -1), rng.integers(0, V, (B, S)))
    else:
        feats = rng.standard_normal((B, S, D)).astype(np.float32)
        w = rng.standard_normal((V, D) if tied else (D, V)).astype(
            np.float32) * 0.5
        labels = rng.integers(0, V, (B, S))
    mask = (rng.random((B, S)) < 0.8).astype(np.float32)
    return {"feats": feats, "w": w, "tied": tied, "z_loss": z_loss,
            "labels": labels.astype(np.int32), "mask": mask, "chunk": 8}


CASES = {"head": _case(0), "tied": _case(1, tied=True),
         "z_loss": _case(2, z_loss=0.5), "ties": _case(3, ties=True),
         "ties_tied": _case(4, tied=True, ties=True)}


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    return {shape: torch_mesh.run_ranks(
        {"name": "vocab_ce", "mesh": shape, "cases": CASES},
        shape[0] * shape[1], tmp_path_factory.mktemp("vocab"))
        for shape in MESHES}


@pytest.mark.parametrize("shape", MESHES)
@pytest.mark.parametrize("name", sorted(CASES))
def test_vocab_parallel_ce_holds_the_whole_one(results, shape, name):
    for rank, out in enumerate(results[shape]):
        r = out[name]
        want, got = r["whole"], r["sharded"]
        close(got["sums"][0], want["sums"][0], f"{name} rank {rank}: nll")
        assert got["sums"][1:] == want["sums"][1:], (rank, got, want)
        close(got["g_f"], want["g_f"], f"{name} rank {rank}: grad feats")
        close(got["g_w"], want["g_w_block"],
              f"{name} rank {rank}: grad of the head's block")
        assert got["g_w"].shape[0 if CASES[name]["tied"] else 1] == \
            V // shape[1]
        assert want["counts"] == {} and got["counts"]["all-reduce"] > 0
    if name.startswith("ties"):
        assert results[shape][0][name]["straddling_ties"] > 0

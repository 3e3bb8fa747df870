"""The port's checkpoints (``repro_torch.train.checkpoint``) and its tree
flattener, against the reference's behaviour.

Mirrors the reference's checkpoint cases (tests/test_checkpoint_data.py,
tests/test_faults.py): round trip, keep-k, atomic writes, ``+inf``
allowed, NaN refused with the good step kept, CRC corruption, a truncated
leaf and a structure mismatch raising ``CheckpointCorrupt``,
``restore_latest_valid`` falling past a corrupt step, ``save_async``
equal to ``save``, and the elastic restore of tests/test_elastic_restore.py
(an unsharded checkpoint onto a (2, 2) mesh of 4 gloo ranks,
``tests/torch_mesh.py``, each keeping its own block).  The manifest is JSON
in the port; for the same leaves it records the reference's dtypes, shapes
and CRC-32s.
"""
import json
import os

import jax.numpy as jnp
import msgpack
import numpy as np
import pytest
import torch

from repro.train import checkpoint as j_ckpt
from repro_torch.mac.engine import EpisodeState
from repro_torch.train import checkpoint as ckpt
from repro_torch.tree import flatten, unflatten
from torch_mesh import run_ranks


def _tree(v):
    return {"w": torch.full((4, 3), float(v)), "step": torch.tensor(v)}


def _state(v=1.0, fad=True):
    """A small EpisodeState: mixed dtypes, 0-d leaves, None leaves."""
    n = 5
    return EpisodeState(
        U=torch.full((n, 3), v), backlog=torch.full((n,), float("inf")),
        pf_avg=torch.arange(n, dtype=torch.float32) * v,
        rr_cursor=torch.tensor(3, dtype=torch.int32),
        harq_bits=torch.zeros(n), harq_retx=torch.ones(n, dtype=torch.int32),
        serving=torch.arange(n, dtype=torch.int32),
        ttt=torch.zeros(n, dtype=torch.int32),
        t=torch.tensor(10, dtype=torch.int32),
        seed=torch.tensor(2**40 + 7, dtype=torch.int64),
        active=torch.tensor([True, False, True, True, False]),
        fad=torch.full((n, 2), v) if fad else None)


def _serving(v=1.0, fad=True):
    return {"state": _state(v, fad), "power": torch.full((2, 1), 5.0 * v),
            "fairness": torch.tensor(0.5 * v)}


def _leaves_equal(a, b):
    ka, la = flatten(a)
    kb, lb = flatten(b)
    assert ka == kb
    for k, x, y in zip(ka, la, lb):
        assert x.dtype == y.dtype and x.device == y.device, k
        assert torch.equal(x, y), k


def _corrupt(d, step, nbytes=8, leaf="00000.npy"):
    path = os.path.join(d, f"step_{step:010d}", leaf)
    with open(path, "r+b") as f:
        f.seek(-nbytes, os.SEEK_END)
        f.write(b"\xff" * nbytes)


# -------------------------------------------------------------- the tree
def test_tree_flatten_paths_and_round_trip():
    tree = _serving()
    keys, leaves = flatten(tree)
    assert keys[:3] == ["fairness", "power", "state/U"]
    assert "state/fad" in keys and "state/cell_state" not in keys
    rebuilt = unflatten(tree, [x.clone() for x in leaves])
    assert type(rebuilt["state"]) is EpisodeState
    assert rebuilt["state"].cell_state is None
    _leaves_equal(rebuilt, tree)
    assert flatten(_serving(fad=False))[0] == [k for k in keys
                                              if k != "state/fad"]
    with pytest.raises(ValueError, match="fewer"):
        unflatten(tree, leaves[:-1])
    with pytest.raises(ValueError, match="more"):
        unflatten(tree, leaves + [leaves[0]])
    assert flatten([(1, None), {"b": 2, "a": [3]}]) == (
        ["0/0", "1/a/0", "1/b"], [1, 3, 2])


# ---------------------------------------------------------- round trips
def test_save_restore_round_trip(tmp_path):
    d = str(tmp_path)
    ckpt.save(d, 7, _serving(7.0), extra={"chunk_tti": 7})
    assert sorted(os.listdir(os.path.join(d, "step_0000000007")))[-1] == \
        "manifest.json"
    tree, extra = ckpt.restore(d, 7, _serving(0.0))
    assert extra == {"chunk_tti": 7}
    _leaves_equal(tree, _serving(7.0))


def test_manifest_matches_the_reference(tmp_path):
    """Same leaves, dtypes, shapes and CRC-32s as the
    reference's msgpack manifest (the state given to it as a dict, so that
    its key strings are the port's)."""
    port, ref = str(tmp_path / "port"), str(tmp_path / "ref")
    tree = _serving(3.0)
    ckpt.save(port, 3, tree)
    # the reference has no int64 seed leaf (JAX runs without x64): its
    # PRNG key is the counterpart
    j_tree = {"state": {k: jnp.asarray(v.numpy()) for k, v
                        in tree["state"]._asdict().items()
                        if v is not None and k != "seed"},
              "power": jnp.asarray(tree["power"].numpy()),
              "fairness": jnp.asarray(tree["fairness"].numpy())}
    j_ckpt.save(ref, 3, j_tree)
    with open(os.path.join(port, "step_0000000003", "manifest.json")) as f:
        m_port = json.load(f)
    with open(os.path.join(ref, "step_0000000003", "manifest.msgpack"),
              "rb") as f:
        m_ref = msgpack.unpackb(f.read())
    # the reference sorts the dict it was given; compare leaf by leaf
    by_key = dict(zip(m_ref["keys"], zip(m_ref["dtypes"], m_ref["shapes"],
                                         m_ref["crc"])))
    assert set(m_port["keys"]) - set(by_key) == {"state/seed"}
    for i, key in enumerate(m_port["keys"]):
        if key == "state/seed":
            continue
        want = by_key[key]
        got = (m_port["dtypes"][i], m_port["shapes"][i], m_port["crc"][i])
        assert got == want, key


def test_keep_last_k_and_atomic(tmp_path):
    d = str(tmp_path)
    for s in range(6):
        ckpt.save(d, s, _tree(s), keep_last=2)
    assert ckpt.all_steps(d) == [4, 5]
    assert ckpt.latest_step(d) == 5
    assert not any(p.endswith(".tmp") for p in os.listdir(d))
    assert ckpt.all_steps(str(tmp_path / "missing")) == []
    assert ckpt.latest_step(str(tmp_path / "missing")) is None


def test_save_async_equals_save(tmp_path):
    sync_dir, async_dir = str(tmp_path / "sync"), str(tmp_path / "async")
    tree = _serving(2.0)
    ckpt.save(sync_dir, 20, tree)
    th = ckpt.save_async(async_dir, 20, tree)
    # the snapshot was taken on the calling thread: a later in-place write
    # to the live tree does not reach the file
    tree["state"].U.add_(100.0)
    th.join(timeout=60)
    assert not th.is_alive()
    for name in sorted(os.listdir(os.path.join(sync_dir, "step_0000000020"))):
        a = open(os.path.join(sync_dir, "step_0000000020", name), "rb").read()
        b = open(os.path.join(async_dir, "step_0000000020", name),
                 "rb").read()
        assert a == b, name
    restored, _ = ckpt.restore(async_dir, 20, _serving(0.0))
    _leaves_equal(restored, _serving(2.0))


def test_restore_reads_structure_not_values(tmp_path):
    """The target's values are never read and never aliased: a target full
    of NaN restores the saved values into fresh tensors."""
    d = str(tmp_path)
    ckpt.save(d, 1, _serving(1.0))
    target = _serving(float("nan"))
    tree, _ = ckpt.restore(d, 1, target)
    _leaves_equal(tree, _serving(1.0))
    for x, y in zip(flatten(tree)[1], flatten(target)[1]):
        assert x.data_ptr() != y.data_ptr()
    with pytest.raises(TypeError, match="NamedSharding"):
        ckpt.restore(d, 1, target, shardings=object())


# --------------------------------------------------------- NaN and +inf
def test_save_allows_inf(tmp_path):
    d = str(tmp_path)
    ckpt.save(d, 1, {"w": torch.full((3,), float("inf")),
                     "step": torch.tensor(1)})
    assert ckpt.all_steps(d) == [1]


def test_save_refuses_nan_and_keeps_the_good_step(tmp_path):
    d = str(tmp_path)
    ckpt.save(d, 1, _serving(1.0))
    bad = _serving(2.0)
    bad["state"].pf_avg[2] = float("nan")
    for save in (ckpt.save, ckpt.save_async):
        with pytest.raises(ValueError, match="NaN.*state/pf_avg"):
            save(d, 2, bad, keep_last=1)
    # the refusal came before any byte moved: step 1 intact and valid
    assert ckpt.all_steps(d) == [1]
    tree, _, step = ckpt.restore_latest_valid(d, _serving(0.0))
    assert step == 1
    _leaves_equal(tree, _serving(1.0))


# ---------------------------------------------------------- corruption
def test_restore_detects_crc_corruption(tmp_path):
    d = str(tmp_path)
    ckpt.save(d, 3, _tree(3))
    ckpt.restore(d, 3, _tree(0))                 # validates clean
    # hit data bytes of the (4, 3) leaf "w" (00001.npy): the npy still
    # parses, only the CRC can tell
    _corrupt(d, 3, leaf="00001.npy")
    with pytest.raises(ckpt.CheckpointCorrupt, match="CRC"):
        ckpt.restore(d, 3, _tree(0))


def test_restore_detects_truncated_leaf(tmp_path):
    d = str(tmp_path)
    ckpt.save(d, 1, _serving(1.0))
    leaf = os.path.join(d, "step_0000000001", "00003.npy")
    data = open(leaf, "rb").read()
    with open(leaf, "wb") as f:
        f.write(data[:len(data) // 2])
    with pytest.raises(ckpt.CheckpointCorrupt, match="unreadable"):
        ckpt.restore(d, 1, _serving(0.0))
    os.remove(leaf)
    with pytest.raises(ckpt.CheckpointCorrupt, match="unreadable"):
        ckpt.restore(d, 1, _serving(0.0))


@pytest.mark.parametrize("change", ["leaf_dropped", "leaf_added", "dtype",
                                    "manifest"])
def test_restore_rejects_structure_mismatch(tmp_path, change):
    d = str(tmp_path)
    ckpt.save(d, 1, _serving(1.0))
    target = _serving(0.0)
    if change == "leaf_dropped":
        target = _serving(0.0, fad=False)
    elif change == "leaf_added":
        target["state"] = target["state"]._replace(
            cell_state=torch.zeros(2, dtype=torch.int32))
    elif change == "dtype":
        target["state"] = target["state"]._replace(
            t=target["state"].t.to(torch.int64))
    else:
        with open(os.path.join(d, "step_0000000001", "manifest.json"),
                  "w") as f:
            f.write("{not json")
    with pytest.raises(ckpt.CheckpointCorrupt):
        ckpt.restore(d, 1, target)


def test_restore_latest_valid_falls_back_past_corrupt(tmp_path):
    d = str(tmp_path)
    for s in (1, 2, 3):
        ckpt.save(d, s, _tree(s), keep_last=0)
    _corrupt(d, 3)
    tree, _, step = ckpt.restore_latest_valid(d, _tree(0))
    assert step == 2
    assert torch.equal(tree["w"], torch.full((4, 3), 2.0))
    # every step corrupt -> CheckpointCorrupt, not silence
    _corrupt(d, 1)
    _corrupt(d, 2)
    with pytest.raises(ckpt.CheckpointCorrupt, match="no valid"):
        ckpt.restore_latest_valid(d, _tree(0))
    with pytest.raises(ckpt.CheckpointCorrupt, match="no step_"):
        ckpt.restore_latest_valid(str(tmp_path / "empty"), _tree(0))


def test_numpy_leaves_round_trip(tmp_path):
    """A non-tensor leaf restores as a numpy array."""
    d = str(tmp_path)
    tree = {"a": np.arange(4, dtype=np.int64), "b": torch.ones(2)}
    ckpt.save(d, 0, tree)
    out, _ = ckpt.restore(d, 0, {"a": np.zeros(4, np.int64),
                                 "b": torch.zeros(2)})
    assert isinstance(out["a"], np.ndarray)
    np.testing.assert_array_equal(out["a"], np.arange(4))
    assert torch.equal(out["b"], torch.ones(2))


# ------------------------------------------------------------ elastic
def test_checkpoint_restores_onto_larger_mesh(tmp_path):
    """The reference's elastic case: saved on one device, restored onto a
    (2, 2) mesh with ``w`` (8, 4) over ("data", "model") and ``b`` (4,)
    over "model"; each rank reads and checks every file and keeps its own
    block, through ``restore`` and ``restore_latest_valid``."""
    d = tmp_path / "ckpt"
    w = torch.arange(32.0).reshape(8, 4)
    ckpt.save(str(d), 5, {"w": w, "b": torch.arange(4.0)},
              extra={"note": "elastic"})
    (tmp_path / "ranks").mkdir()
    outs = run_ranks(dict(name="restore", dir=str(d)), 4, tmp_path / "ranks")
    seen = set()
    for out in outs:
        r, c = out["coord"]["data"], out["coord"]["model"]
        seen.add((r, c))
        want_w = w.numpy()[4 * r:4 * r + 4, 2 * c:2 * c + 2]
        want_b = np.arange(4.0, dtype=np.float32)[2 * c:2 * c + 2]
        for tree in (out["tree"], out["latest"]):
            np.testing.assert_array_equal(tree["w"], want_w)
            np.testing.assert_array_equal(tree["b"], want_b)
        assert out["extra"] == {"note": "elastic"} and out["step"] == 5
    assert seen == {(0, 0), (0, 1), (1, 0), (1, 1)}

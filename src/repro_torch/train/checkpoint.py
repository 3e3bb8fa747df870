"""Checkpointing: atomic, keep-last-k, async, self-validating.

The port of the CRRM part of ``repro.train.checkpoint``.  Layout:

    <dir>/step_<n:010d>/ {manifest.json, 00000.npy, 00001.npy, ...}

* atomic     -- written to ``step_<n>.tmp`` then ``os.replace``d, so a crash
                mid-write never leaves a half checkpoint that restore would
                pick up.
* keep-k     -- old steps are removed after a successful write, so a bad
                latest step never costs the good ones behind it.
* async      -- :func:`save_async` copies the leaves to host memory and
                refuses NaN on the calling thread, then writes on a daemon
                thread; all writes of the process go through one lock.
* validating -- the manifest records a CRC-32 per leaf; :func:`restore`
                checks bytes, dtype and shape and raises
                :class:`CheckpointCorrupt` on any mismatch (or an unreadable
                file), and :func:`restore_latest_valid` walks the steps
                newest first past corrupt ones.  The save path refuses a
                tree holding NaN (``ValueError`` before any byte is
                written), so a poisoned state never enters the keep-k
                window; ``+inf`` is allowed: it is the backlog's legal
                full-buffer sentinel.

The manifest is JSON (the reference writes msgpack), and a tree is any
nesting of dicts, NamedTuples, tuples and lists with tensor leaves
(``repro_torch.tree``): leaf ``i`` of the flattened tree is file
``{i:05d}.npy`` and its key path (``state/U``, ``power``) is in the
manifest.  :func:`restore` reads only the target tree's structure, dtypes
and devices, never its values, and builds fresh tensors on each target
leaf's device, so restoring over the state of an abandoned computation is
safe.  Elastic resharding: with ``shardings=`` (a matching tree of
``core.distributed.NamedSharding``) each rank of a mesh reads and checks
every file and keeps its own block, whatever mesh wrote the checkpoint; no
collective is needed.
"""
from __future__ import annotations

import json
import os
import re
import shutil
import threading
import zlib
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.core.distributed import NamedSharding
from repro_torch.parallel import zero
from repro_torch.robust.guard import nan_leaves
from repro_torch.tree import _children, flatten, unflatten

MANIFEST = "manifest.json"


class CheckpointCorrupt(RuntimeError):
    """A checkpoint step failed validation: missing or truncated files, a
    CRC/dtype/shape mismatch against its manifest, or a manifest that does
    not match the target tree's structure."""


def _refuse_nan(keys, leaves):
    """Never persist NaN: a corrupt tree must not enter the keep-k window.

    One reduction per float leaf, read back once; the error names the
    poisoned leaves.  NaN only: ``+inf`` is legitimate state.
    """
    bad = nan_leaves(keys, leaves)
    if bad:
        raise ValueError(
            "refusing to checkpoint a tree containing NaN "
            f"(leaves: {', '.join(bad)}); a corrupt snapshot must never "
            "displace a valid one -- roll back instead")


def _host(x) -> np.ndarray:
    """A host copy of one leaf that no later write to ``x`` can change."""
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", copy=True).numpy()
    return np.array(x)


def _snapshot(tree):
    keys, leaves = flatten(tree)
    _refuse_nan(keys, leaves)
    return keys, [_host(x) for x in leaves]


def save(ckpt_dir: str, step: int, tree: Any, keep_last: int = 3,
         extra: Optional[dict] = None) -> str:
    """Write ``tree`` as step ``step``; returns the step's directory."""
    keys, host = _snapshot(tree)
    return _write(ckpt_dir, step, keys, host, keep_last, extra or {})


_save_lock = threading.Lock()


def save_async(ckpt_dir: str, step: int, tree: Any, keep_last: int = 3,
               extra: Optional[dict] = None) -> threading.Thread:
    """Snapshot to host now; write to disk on a daemon thread (returned).

    The NaN refusal also happens now, on the calling thread: the caller
    learns at once that its state is poisoned, not from a lost exception
    of the writer thread.
    """
    keys, host = _snapshot(tree)
    t = threading.Thread(
        target=_write, args=(ckpt_dir, step, keys, host, keep_last,
                             extra or {}), daemon=True)
    t.start()
    return t


def _crc(x: np.ndarray) -> int:
    return zlib.crc32(np.ascontiguousarray(x).reshape(-1).view(np.uint8))


def _write(ckpt_dir, step, keys, host_leaves, keep_last, extra):
    with _save_lock:
        final = os.path.join(ckpt_dir, f"step_{step:010d}")
        tmp = final + ".tmp"
        os.makedirs(tmp, exist_ok=True)
        manifest = {"step": step, "keys": keys, "extra": extra,
                    "dtypes": [str(x.dtype) for x in host_leaves],
                    "shapes": [list(x.shape) for x in host_leaves],
                    "crc": [_crc(x) for x in host_leaves]}
        for i, x in enumerate(host_leaves):
            np.save(os.path.join(tmp, f"{i:05d}.npy"), x)
        with open(os.path.join(tmp, MANIFEST), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.replace(tmp, final)
        _gc(ckpt_dir, keep_last)
        return final


def _gc(ckpt_dir, keep_last):
    steps = all_steps(ckpt_dir)
    for s in steps[:-keep_last] if keep_last else []:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s:010d}"),
                      ignore_errors=True)


def all_steps(ckpt_dir) -> list[int]:
    """The completed steps under ``ckpt_dir``, ascending."""
    if not os.path.isdir(ckpt_dir):
        return []
    out = []
    for name in os.listdir(ckpt_dir):
        m = re.fullmatch(r"step_(\d+)", name)
        if m:
            out.append(int(m.group(1)))
    return sorted(out)


def latest_step(ckpt_dir) -> Optional[int]:
    steps = all_steps(ckpt_dir)
    return steps[-1] if steps else None


def _read_manifest(path, step) -> dict:
    try:
        with open(os.path.join(path, MANIFEST)) as f:
            manifest = json.load(f)
        n = len(manifest["keys"])
        if any(len(manifest[k]) != n for k in ("dtypes", "shapes", "crc")):
            raise ValueError("per-leaf lists of unequal length")
        return manifest
    except (OSError, ValueError, KeyError, TypeError) as e:
        raise CheckpointCorrupt(
            f"step {step}: unreadable manifest ({e})") from e


def _dtype_name(leaf) -> str:
    if isinstance(leaf, torch.Tensor):
        return str(torch.empty((), dtype=leaf.dtype).numpy().dtype)
    return str(np.asarray(leaf).dtype)


def restore(ckpt_dir: str, step: int, target_tree: Any,
            shardings: Any = None) -> tuple[Any, dict]:
    """Restore step ``step`` into the structure of ``target_tree``:
    ``(tree, extra)``.

    Every leaf is checked against the manifest (CRC-32 over the raw bytes,
    dtype, shape) and its dtype against the target leaf's; any mismatch or
    unreadable file raises :class:`CheckpointCorrupt`.  A tensor leaf is
    rebuilt on its target leaf's device, any other leaf as a numpy array.

    ``shardings``, a tree of ``core.distributed.NamedSharding`` leaves (or
    ``None`` for a whole leaf) in ``target_tree``'s structure, restores
    each tensor leaf as this rank's block of the saved global array under
    its spec (``parallel.zero.block`` by the leaf's key: a Mamba
    ``in_proj``'s block is its compute columns); the target's leaves then
    describe the global arrays.
    """
    path = os.path.join(ckpt_dir, f"step_{step:010d}")
    manifest = _read_manifest(path, step)
    keys, leaves = flatten(target_tree)
    if keys != manifest["keys"]:
        raise CheckpointCorrupt(
            f"step {step}: checkpoint/model structure mismatch")
    shards = _shardings(shardings, target_tree)
    out = []
    for i, (key, tgt) in enumerate(zip(keys, leaves)):
        dtype, shape = manifest["dtypes"][i], manifest["shapes"][i]
        if _dtype_name(tgt) != dtype:
            raise CheckpointCorrupt(
                f"step {step}: leaf {key} is {dtype} in the checkpoint, "
                f"{_dtype_name(tgt)} in the target tree")
        leaf_path = os.path.join(path, f"{i:05d}.npy")
        try:
            arr = np.load(leaf_path)
        except (OSError, ValueError, EOFError, SyntaxError) as e:
            raise CheckpointCorrupt(
                f"step {step}: leaf {key} ({os.path.basename(leaf_path)}) "
                f"unreadable ({e})") from e
        if str(arr.dtype) != dtype or list(arr.shape) != shape:
            raise CheckpointCorrupt(
                f"step {step}: leaf {key} is {arr.dtype}{arr.shape}, "
                f"manifest says {dtype}{tuple(shape)}")
        if _crc(arr) != manifest["crc"][i]:
            raise CheckpointCorrupt(
                f"step {step}: leaf {key} CRC mismatch (bytes corrupted on "
                "disk)")
        if isinstance(tgt, torch.Tensor):
            leaf = torch.from_numpy(arr)
            if shards[i] is not None:
                leaf = zero.block(shards[i].mesh, leaf, shards[i].spec, key)
            out.append(leaf.to(device=tgt.device))
        else:
            out.append(arr)
    return unflatten(target_tree, out), manifest["extra"]


def _shardings(shardings, target) -> list:
    """One ``NamedSharding`` (or ``None``) per leaf of ``target``, in
    :func:`~repro_torch.tree.flatten`'s order; ``shardings`` has the
    target's structure (``None`` for a whole subtree)."""
    if target is None:
        return []
    kids = _children(target)
    if kids is None:                                   # a leaf
        if shardings is None or isinstance(shardings, NamedSharding):
            return [shardings]
    elif shardings is None:
        return [None] * len(flatten(target)[1])
    elif not isinstance(shardings, NamedSharding):
        skids = _children(shardings)
        if skids is not None and [k for k, _ in skids] == [k for k, _ in kids]:
            return [s for (_, sh), (_, t) in zip(skids, kids)
                    for s in _shardings(sh, t)]
    raise TypeError("shardings= must be a tree of core.distributed."
                    "NamedSharding (or None) leaves in the target tree's "
                    "structure")


def restore_latest_valid(ckpt_dir: str, target_tree: Any,
                         shardings: Any = None) -> tuple[Any, dict, int]:
    """Restore the newest step that passes validation.

    Walks :func:`all_steps` newest first, skipping every step that
    :func:`restore` finds corrupt -- the recovery primitive behind the twin
    server's rollback.  Returns ``(tree, extra, step)``; raises
    :class:`CheckpointCorrupt` when no step validates (an empty directory
    too).
    """
    failures = []
    for step in reversed(all_steps(ckpt_dir)):
        try:
            tree, extra = restore(ckpt_dir, step, target_tree, shardings)
            return tree, extra, step
        except CheckpointCorrupt as e:
            failures.append(str(e))
    detail = "; ".join(failures) if failures else "no step_* directories"
    raise CheckpointCorrupt(
        f"no valid checkpoint under {ckpt_dir}: {detail}")

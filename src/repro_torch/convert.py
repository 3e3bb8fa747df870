"""Carry the JAX package's state over into the port.

Every input is plain data -- a dict of ``CRRM_parameters`` fields and
numpy arrays, or an LM's param and cache trees of numpy arrays
(:func:`lm_params`, :func:`lm_cache`) -- so this module needs neither
package of the reference.
The layouts and dtypes stay those of the reference at every public
function: attachment, serving cells, TTT counters, HARQ retx counts, the
round-robin cursor and the TTI counter stay int32; floats stay float32.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.crrm import CRRM
from repro_torch.core.params import CRRM_parameters
from repro_torch.env.crrm_env import EnvObs, TopoEnvState
from repro_torch.mac.engine import EpisodeState, EpisodeStatic
from repro_torch.models.registry import make_arch
from repro_torch.obs.telemetry import Telemetry
from repro_torch.sim.radio import RadioState
from repro_torch.tree import flatten


def to_tensor(x, device):
    """A numpy array (or scalar) as a tensor on ``device``: integers as
    int32, booleans as bool, everything else as float32."""
    if x is None:
        return None
    arr = np.asarray(x)
    if arr.dtype == np.bool_:
        dtype = torch.bool
    elif np.issubdtype(arr.dtype, np.integer):
        dtype = torch.int32
    else:
        dtype = torch.float32
    # a C-ordered copy: writable, and a 0-d scalar stays 0-d
    # (np.ascontiguousarray would make it (1,))
    return torch.as_tensor(np.array(arr, order="C"), device=device).to(dtype)


def params_from_dict(fields: dict) -> CRRM_parameters:
    """The port's ``CRRM_parameters`` from the reference's field values."""
    names = {f.name for f in dataclasses.fields(CRRM_parameters)}
    unknown = set(fields) - names
    if unknown:
        raise ValueError(f"unknown CRRM_parameters fields: {sorted(unknown)}")
    return CRRM_parameters(**fields)


def crrm_from_reference(fields: dict, roots: dict, device) -> CRRM:
    """A port ``CRRM`` on ``device`` whose graph roots are the reference's.

    ``roots`` holds the numpy values of the reference graph's ``U``, ``C``,
    ``P``, ``boresight`` and ``fading`` roots; the backlog may be given as
    ``buffer``.
    """
    fields = dict(fields, ue_positions=np.asarray(roots["U"]),
                  cell_positions=np.asarray(roots["C"]))
    sim = CRRM(params_from_dict(fields), device=device)
    sim.P.set(to_tensor(roots["P"], sim.device))
    sim.boresight.set(to_tensor(roots["boresight"], sim.device))
    sim.fading.set(to_tensor(roots["fading"], sim.device))
    if "buffer" in roots:
        sim.buffer.set(to_tensor(roots["buffer"], sim.device))
    return sim


def _tuple(cls, data: dict, device):
    return cls(**{f: to_tensor(data.get(f), device) for f in cls._fields})


def episode_static(data: dict, device) -> EpisodeStatic:
    """The port's ``EpisodeStatic`` from the reference's fields."""
    return _tuple(EpisodeStatic, data, device)


def episode_state(data: dict, device) -> EpisodeState:
    """The port's ``EpisodeState`` from the reference's fields (its PRNG
    ``key`` is ignored: the port draws through ``mac.engine.Draws``; the
    env's episode ``seed`` is taken where ``data`` has one).  The churn
    leaves (``active`` bool, ``fad``) and the fault codes (``cell_state``
    int32) carry over where present, and a batched state (every leaf with
    a leading B, as the reference's ``vmap`` makes it) stays batched."""
    return _tuple(EpisodeState, {k: v for k, v in data.items() if k != "key"},
                  device)


def radio_state(data: dict, device) -> RadioState:
    """The port's ``RadioState`` from the reference's fields (None stays
    None)."""
    return _tuple(RadioState, data, device)


def telemetry(data: dict, device) -> Telemetry:
    """The port's ``Telemetry`` from the reference's fields (None stays
    None)."""
    return _tuple(Telemetry, data, device)


def env_obs(data: dict, device) -> EnvObs:
    """The port's ``EnvObs`` from the reference's ``tput``/``backlog``."""
    return _tuple(EnvObs, data, device)


def topo_env_state(data: dict, device) -> TopoEnvState:
    """The port's ``TopoEnvState`` from the reference's ``ep`` and
    ``static`` field dicts."""
    return TopoEnvState(ep=episode_state(data["ep"], device),
                        static=episode_static(data["static"], device))


def twin_tree(data: dict, device) -> dict:
    """The port's serving tuple ``{"state", "power", "fairness"}`` from the
    reference twin server's (numpy leaves; its state without the PRNG
    ``key`` and with the episode ``seed`` given, which becomes the int64
    ``seed`` leaf): saved with ``train.checkpoint.save``, it restores
    into a port ``TwinServer``, which then serves the reference's state."""
    fields = dict(data["state"])
    seed = fields.pop("seed", None)
    state = episode_state(fields, device)
    if seed is not None:
        state = state._replace(seed=torch.tensor(
            int(np.asarray(seed)), dtype=torch.int64, device=device))
    return {"state": state,
            "power": to_tensor(np.asarray(data["power"], np.float32), device),
            "fairness": to_tensor(np.asarray(data["fairness"], np.float32),
                                  device)}


def _tree(data, device):
    """Nested dicts and lists of numpy leaves as the same nesting of
    tensors (:func:`to_tensor` dtypes)."""
    if isinstance(data, dict):
        return {k: _tree(v, device) for k, v in data.items()}
    if isinstance(data, (list, tuple)):
        return type(data)(_tree(v, device) for v in data)
    return to_tensor(data, device)


def policy_params(data: dict, device) -> dict:
    """The port's actor-critic params (``rl.policy``) from the reference's
    (numpy leaves): the same dict tree -- ``actor``, ``critic``,
    ``layers`` (a list of ``{"w", "b"}``) and ``log_std`` -- in float32."""
    if set(data) != {"actor", "critic", "layers", "log_std"}:
        raise ValueError(f"not an actor-critic params tree: keys "
                         f"{sorted(data)}")
    return _tree(data, device)


def adamw_state(data: dict, device) -> dict:
    """The port's ``train.optim.adamw`` state from the reference's (numpy
    leaves): the ``mu``/``nu`` moment trees in float32 and the int32 step
    ``count``."""
    if set(data) != {"mu", "nu", "count"}:
        raise ValueError(f"not an adamw state: keys {sorted(data)}")
    return _tree(data, device)



_LM_DTYPES = {"float32": torch.float32, "float16": torch.float16,
              "int8": torch.int8}


def _lm_tensor(x, device):
    """A numpy leaf of an LM tree as a tensor of the same dtype (bfloat16,
    which numpy carries as ``ml_dtypes.bfloat16``, through its bits)."""
    arr = np.asarray(x)
    if arr.dtype.name == "bfloat16":
        bits = torch.from_numpy(np.array(arr.view(np.uint16), order="C"))
        return bits.view(torch.bfloat16).to(device)
    if arr.dtype.name not in _LM_DTYPES:
        raise ValueError(f"no LM leaf of dtype {arr.dtype}")
    return torch.as_tensor(np.array(arr, order="C"), device=device).to(
        _LM_DTYPES[arr.dtype.name])


def _lm_tree(data, device):
    if isinstance(data, dict):
        return {k: _lm_tree(v, device) for k, v in data.items()}
    return _lm_tensor(data, device)


def lm_params(tree: dict, cfg, device) -> dict:
    """The port's LM params (``models.transformer``, or ``models.encdec``
    for the encoder-decoder family) from the reference's param tree as
    numpy arrays: the key paths and shapes of ``init_params(cfg)`` (every
    layer leaf stacked on a leading layer axis), each leaf's dtype kept
    (``param_dtype``, and float32 where the reference keeps it: the
    router, ``dt_proj``, ``dt_bias``, ``A_log``, ``D``)."""
    want_keys, want = flatten(make_arch(cfg).init(torch.Generator(),
                                                  device="meta"))
    keys, leaves = flatten(tree)
    if keys != want_keys:
        raise ValueError(f"not a {cfg.name} param tree: keys "
                         f"{sorted(set(keys) ^ set(want_keys))} differ")
    bad = [k for k, w, x in zip(keys, want, leaves)
           if tuple(w.shape) != np.shape(x)]
    if bad:
        raise ValueError(f"{cfg.name}: shapes differ at {bad}")
    return _lm_tree(tree, device)


_OPT_KEYS = ({"mu", "nu", "count"},       # adamw
             {"m", "count"},              # adafactor
             {"mu", "count"})             # sgdm


def train_state(tree: dict, cfg, device) -> dict:
    """The port's train state ``{params, opt, step}`` (``train.step``)
    from the reference's (numpy leaves): the params through
    :func:`lm_params`, the optimizer state of ``train.optim``'s
    ``adamw`` (``mu``/``nu``), ``adafactor`` (``m``: a ``{"vr", "vc"}``
    or ``{"v"}`` dict per param) or ``sgdm`` (``mu``) in float32, its
    ``count`` and the ``step`` int32."""
    if set(tree) != {"params", "opt", "step"}:
        raise ValueError(f"not a train state: keys {sorted(tree)}")
    if set(tree["opt"]) not in _OPT_KEYS:
        raise ValueError(f"not an optimizer state of train.optim: keys "
                         f"{sorted(tree['opt'])}")
    return {"params": lm_params(tree["params"], cfg, device),
            "opt": _tree(tree["opt"], device),
            "step": to_tensor(tree["step"], device)}


def lm_cache(tree: dict, device) -> dict:
    """The port's decode caches from the reference's (numpy leaves, the
    same keys and stacked shapes; int8 values stay int8)."""
    if not {"k", "v"} <= set(tree) and not {"h", "conv"} <= set(tree):
        raise ValueError(f"not an LM cache: keys {sorted(tree)}")
    return _lm_tree(tree, device)

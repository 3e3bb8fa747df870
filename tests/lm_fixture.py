"""qwen1.5-0.5b served at full width, as data: the reference's greedy runs.

The card has no JAX, so the reference's serving loop runs here once
(``tests/make_lm_fixture.py``) and its numbers live in
``tests/data/lm_serve_qwen1p5_0p5b.npz``.  The weights are not committed:
:func:`param_tree` builds them from a numpy seed wherever the check runs
(about 0.62 B parameters, 2.5 GB in float32), so the port on the card
(``chip_smoke.py`` phase 17, ``tests/test_torch_cuda.py``) serves the very
model the reference served.

The run is the reference test's (``tests/test_system.py``): two requests,
``arange(5)`` and ``arange(9)``, left-padded into 4 slots with ``max_len``
64, 8 new tokens each -- one prefill and 7 decode steps in lockstep.  It
is kept twice: in the config's own bfloat16 compute, and in float32
(``dataclasses.replace(cfg, dtype="float32")``).  For every slot and step
the file holds the argmax, its top-2 margin, the argmax logit and the
logits at :data:`N_PROBE` fixed vocab ids, and the generated tokens.

Contract (:func:`hold`), per slot: the logits of a step are held while
every earlier token of the slot agreed (so the step's inputs are the
same); tokens are exact, except that a step whose reference top-2 margin
is under :data:`NEAR_TIE` may flip its token (counted; the slot's stream
then parts and nothing after it is compared).  ``TOL`` is the logits'
tolerance, in logit units (the logits are O(1) here): float32 1e-3, the
sum order of 24 layers' matmuls and float32 transcendental ulps;
bfloat16 0.25, set before the card's first run from the reference's own
bfloat16 rounding: its bfloat16 prefill logits lie up to 0.0755 from its
float32 ones on the same inputs (``make_lm_fixture.py`` prints it; the
logits reach 4.33), and two independent bfloat16 computations may each
lie that far from float32, on either side, so 0.25 is that twice with a
margin.  A near tie is a margin under twice the tolerance: both top
logits may move by ``TOL``.

This module imports neither JAX nor the JAX package.
"""
from __future__ import annotations

import dataclasses
import math
from pathlib import Path

import numpy as np
import torch

from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.models.registry import make_arch
from repro_torch.serve.engine import ServeEngine

DATA = Path(__file__).resolve().parent / "data"
PATH = DATA / "lm_serve_qwen1p5_0p5b.npz"
ARCH = "qwen1.5-0.5b"
SEED = 0
SLOTS, MAX_LEN, MAX_NEW = 4, 64, 8
PROMPT_LENS = (5, 9)                # the reference test's two requests
N_PROBE = 64
DTYPES = ("bfloat16", "float32")
TOL = {"float32": 1e-3, "bfloat16": 0.25}
NEAR_TIE = {k: 2 * v for k, v in TOL.items()}


def config(dtype: str, reduced: bool = False):
    """qwen1.5-0.5b (reduced: its tiny same-family config) computing in
    ``dtype``."""
    return dataclasses.replace(get_config(ARCH, reduced=reduced), dtype=dtype)


def prompts(cfg):
    return [np.arange(n) % cfg.vocab_size for n in PROMPT_LENS]


def probe_ids(cfg) -> np.ndarray:
    """The fixed vocab ids whose logits the file keeps."""
    rng = np.random.default_rng(1)
    return np.sort(rng.choice(cfg.vocab_size, N_PROBE, replace=False))


def param_tree(cfg, seed: int = SEED) -> dict:
    """The dense family's param tree (``models.transformer.init_params``'s
    keys and stacked shapes) as float32 numpy arrays drawn from ``seed``:
    every weight N(0, 1) clipped at +-2 and scaled by 1/sqrt(fan-in) (the
    scale and the clip of ``dense_init``), norms at 1, biases at 0, the
    embedding 0.02 N(0, 1)."""
    if cfg.family != "dense" or cfg.tie_embeddings:
        raise ValueError(f"{cfg.name}: the fixture builds the untied dense "
                         f"family only")
    rng = np.random.default_rng(seed)
    L, d, h, kv, hd, f = (cfg.n_layers, cfg.d_model, cfg.n_heads,
                          cfg.n_kv_heads, cfg.head_dim, cfg.d_ff)

    def dense(shape, fan_in):
        w = rng.standard_normal(shape, dtype=np.float32)
        np.clip(w, -2.0, 2.0, out=w)
        w *= np.float32(1.0 / math.sqrt(fan_in))
        return w

    ones = lambda *s: np.ones(s, np.float32)
    attn = {"wq": dense((L, d, h, hd), d), "wk": dense((L, d, kv, hd), d),
            "wv": dense((L, d, kv, hd), d), "wo": dense((L, h, hd, d), h * hd)}
    if cfg.qkv_bias:
        attn.update(bq=np.zeros((L, h, hd), np.float32),
                    bk=np.zeros((L, kv, hd), np.float32),
                    bv=np.zeros((L, kv, hd), np.float32))
    emb = rng.standard_normal((cfg.vocab_size, d), dtype=np.float32)
    emb *= np.float32(0.02)
    return {
        "layers": {"ln1": {"scale": ones(L, d)}, "attn": attn,
                   "ln2": {"scale": ones(L, d)},
                   "mlp": {"wi_gate": dense((L, d, f), d),
                           "wi_up": dense((L, d, f), d),
                           "wo": dense((L, f, d), f)}},
        "final_norm": {"scale": ones(d)},
        "embed": {"embedding": emb},
        "lm_head": {"kernel": dense((d, cfg.vocab_size), d)},
    }


def checksum(tree: dict) -> np.ndarray:
    """float64 sums of a few leaves: the file records them, so a numpy
    whose draws differ is caught before any comparison."""
    leaves = (tree["layers"]["attn"]["wq"], tree["layers"]["mlp"]["wo"],
              tree["embed"]["embedding"], tree["lm_head"]["kernel"])
    return np.array([float(np.asarray(x, np.float64).sum()) for x in leaves])


def top2(logits: np.ndarray):
    """(argmax, top-2 margin, top logit) over the last axis."""
    part = np.partition(logits, -2, axis=-1)
    top, second = part[..., -1], part[..., -2]
    return np.argmax(logits, axis=-1), top - second, top


def summarize(steps: list, probe: np.ndarray) -> dict:
    """The kept numbers of ``steps`` ((B, V) float32 logits per step)."""
    lg = np.stack(steps, axis=1)                       # (B, T, V)
    arg, margin, top = top2(lg)
    return {"argmax": arg.astype(np.int64), "margin": margin, "top": top,
            "probe": lg[..., probe]}


def hold(got: dict, want: dict, got_tokens, want_tokens, dtype: str) -> dict:
    """Hold one run to the reference's (both :func:`summarize` dicts plus
    their per-request tokens) under the contract above.  Returns the
    counts; raises ``AssertionError`` on a breach."""
    tol, tie = TOL[dtype], NEAR_TIE[dtype]
    B, T = want["argmax"].shape
    held_steps, near_ties, parted, max_err = 0, 0, [], 0.0
    for i in range(B):
        for t in range(T):
            # the step's inputs agree: its logits are held
            err = max(float(np.abs(got["probe"][i, t]
                                   - want["probe"][i, t]).max()),
                      abs(float(got["top"][i, t]) - float(want["top"][i, t])))
            max_err = max(max_err, err)
            if err > tol:
                raise AssertionError(
                    f"{dtype} slot {i} step {t}: logits off by {err:.3e} "
                    f"> {tol}")
            held_steps += 1
            if want["margin"][i, t] < tie:
                near_ties += 1
            if got["argmax"][i, t] != want["argmax"][i, t]:
                if want["margin"][i, t] >= tie:
                    raise AssertionError(
                        f"{dtype} slot {i} step {t}: token "
                        f"{got['argmax'][i, t]} != {want['argmax'][i, t]} "
                        f"at a top-2 margin {want['margin'][i, t]:.4f} "
                        f">= {tie}")
                parted.append((i, t))
                break
    parted_slots = {i for i, _ in parted}
    for r, (g, w) in enumerate(zip(got_tokens, want_tokens)):
        if len(g) != len(w):
            raise AssertionError(f"request {r}: {len(g)} tokens, want "
                                 f"{len(w)}")
        if r not in parted_slots and list(g) != list(w):
            raise AssertionError(f"{dtype} request {r}: tokens {list(g)} "
                                 f"!= {list(w)}")
    return {"held_steps": held_steps, "near_ties": near_ties,
            "parted": parted, "max_err": max_err,
            "min_margin": float(want["margin"].min())}


def recording(arch, steps: list):
    """``arch`` whose prefill and decode_step append their last logits
    ((B, V) float32 numpy) to ``steps``: the engine's own calls, observed."""
    def prefill(p, b, max_len):
        out = arch.prefill(p, b, max_len)
        steps.append(out[0][:, -1].float().cpu().numpy())
        return out

    def decode_step(p, b, c, pos):
        out = arch.decode_step(p, b, c, pos)
        steps.append(out[0][:, -1].float().cpu().numpy())
        return out

    return dataclasses.replace(arch, prefill=prefill, decode_step=decode_step)


def serve(cfg, params: dict, device) -> tuple:
    """The port's ``ServeEngine`` over ``params`` (port tensors) on the
    reference test's requests: (tokens per request, summarized logits)."""
    eng = ServeEngine(make_arch(cfg), batch_slots=SLOTS, max_len=MAX_LEN,
                      device=device)
    eng.params = params
    steps: list = []
    eng.arch = recording(eng.arch, steps)
    reqs = [eng.submit(p, max_new_tokens=MAX_NEW) for p in prompts(cfg)]
    out = eng.run()
    tokens = [out["results"][r.rid] for r in reqs]
    return tokens, summarize(steps, probe_ids(cfg))


def read(dtype: str) -> tuple:
    """(reference tokens per request, summarized logits, checksum) of the
    file."""
    with np.load(PATH) as f:
        want = {k: f[f"{dtype}_{k}"] for k in ("argmax", "margin", "top",
                                               "probe")}
        tokens = list(f[f"{dtype}_tokens"])
        return tokens, want, f["checksum"]


def check(device, dtype: str, params_np: dict | None = None) -> dict:
    """Serve qwen1.5-0.5b at full width on ``device`` in ``dtype`` over
    the seeded weights and hold it to the file (``params_np``: the tree of
    :func:`param_tree`, to build it once for both dtypes)."""
    cfg = config(dtype)
    tree = param_tree(cfg) if params_np is None else params_np
    want_tokens, want, want_sum = read(dtype)
    got_sum = checksum(tree)
    if not np.allclose(got_sum, want_sum, rtol=1e-6, atol=1e-3):
        raise AssertionError(f"the seeded weights differ from those the "
                             f"reference served: {got_sum} vs {want_sum}")
    params = convert.lm_params(tree, cfg, device)
    tokens, got = serve(cfg, params, device)
    out = hold(got, want, tokens, want_tokens, dtype)
    out["tokens"] = tokens
    return out

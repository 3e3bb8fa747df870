"""The port's serving path against the reference's, on the CPU.

``repro_torch.serve.engine.ServeEngine`` serving qwen1.5-0.5b (reduced)
over the reference's params is held to the reference's model functions
driven in ``repro.serve.engine.ServeEngine.run``'s own loop
(``make_lm_fixture.reference_serve``; the reference's engine object
cannot run unsharded, ROADMAP queue 3), under ``tests/lm_fixture.py``'s
contract: logits within 1e-3 while a slot's inputs agree, tokens exact off
counted near ties (a reference top-2 margin under 2e-3).  Also: the
reference test's request shapes and determinism, refills from the queue,
seeded sampling, the CLI, the fixture's contract at reduced width, the
committed fixture file, and the top-2 margin rule itself.
"""
import dataclasses

import jax  # noqa: F401  (the parity suites import both packages)
import numpy as np
import pytest
import torch

import lm_fixture as lf
import lm_parity as lp
import make_lm_fixture as mk
import torch_parity
from repro_torch.launch import serve as t_serve
from repro_torch.serve.engine import ServeEngine

ARCH = "qwen1.5-0.5b"


@pytest.fixture(scope="module")
def qwen():
    return lp.pair(ARCH)


def engine(p, slots=2, **kw):
    eng = ServeEngine(p.ta, batch_slots=slots, max_len=64, device="cpu", **kw)
    eng.params = p.tparams
    return eng


def reference(p, prompts, max_new, slots=2):
    return mk.reference_serve(p.ja, p.jparams, prompts, max_new, slots, 64)


def test_engine_serves_the_reference_s_tokens(qwen):
    """The reference test's two requests (6 and 4 new tokens), 2 slots."""
    eng = engine(qwen)
    steps = []
    eng.arch = lf.recording(eng.arch, steps)
    prompts = [np.arange(5) % 512, np.arange(9) % 512]
    r1 = eng.submit(prompts[0], max_new_tokens=6)
    r2 = eng.submit(prompts[1], max_new_tokens=4)
    out = eng.run()
    want_tokens, want_steps = reference(qwen, prompts, 6)
    probe = lf.probe_ids(qwen.tcfg)
    got, want = lf.summarize(steps, probe), lf.summarize(want_steps, probe)
    res = lf.hold(got, want, [out["results"][r1.rid],
                              out["results"][r2.rid][:4]],
                  [want_tokens[0], want_tokens[1][:4]], "float32")
    assert res["parted"] == [] and res["held_steps"] == 12
    # ``out`` also equals the reference in its shape
    assert len(out["results"][r1.rid]) == 6
    assert len(out["results"][r2.rid]) == 4
    assert out["results"][r2.rid] == want_tokens[1][:4]
    assert out["n_tokens"] == 10 and out["tokens_per_s"] > 0


def test_greedy_runs_are_bit_equal(qwen):
    logs = []
    for _ in range(2):
        eng = engine(qwen)
        steps = []
        eng.arch = lf.recording(eng.arch, steps)
        eng.submit(np.arange(5), max_new_tokens=6)
        eng.submit(np.arange(9), max_new_tokens=4)
        logs.append((eng.run()["results"], steps))
    assert logs[0][0] == logs[1][0]
    for a, b in zip(logs[0][1], logs[1][1]):
        np.testing.assert_array_equal(a, b)


def test_own_init_is_seeded(qwen):
    a = ServeEngine(qwen.ta, batch_slots=2, max_len=32, seed=5, device="cpu")
    b = ServeEngine(qwen.ta, batch_slots=2, max_len=32, seed=5, device="cpu")
    for x, y in zip(lp.np_tree(a.params)["layers"]["attn"].values(),
                    lp.np_tree(b.params)["layers"]["attn"].values()):
        np.testing.assert_array_equal(x, y)
    for eng in (a, b):
        eng.submit(np.arange(7), max_new_tokens=3)
    assert a.run()["results"] == b.run()["results"]


def test_refills_slots_from_the_queue(qwen, capsys):
    """5 requests through 2 slots: three lockstep batches, each the
    reference's loop on that batch."""
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, 512, n) for n in (4, 7, 3, 6, 5)]
    news = [3, 5, 2, 4, 3]
    eng = engine(qwen)
    reqs = [eng.submit(p, max_new_tokens=n) for p, n in zip(prompts, news)]
    out = eng.run(progress=True)
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == "[serve] step 1/5 pos 7" and len(lines) == 5 + 4 + 3
    assert [r.rid for r in reqs] == [0, 1, 2, 3, 4]
    assert all(r.done for r in reqs) and eng.slots == [None, None]
    for lo in (0, 2, 4):
        batch = slice(lo, lo + 2)
        want, _ = reference(qwen, prompts[batch], max(news[batch]))
        for r, w in zip(reqs[batch], want):
            assert out["results"][r.rid] == w[:r.max_new_tokens]
    assert out["n_tokens"] == sum(news)


def test_sampling_is_seeded(qwen):
    def sample(seed):
        eng = engine(qwen, temperature=0.8, seed=seed)
        eng.params = qwen.tparams
        eng.submit(np.arange(6), max_new_tokens=12)
        return eng.run()["results"][0]

    a, b, c = sample(1), sample(1), sample(2)
    assert a == b and a != c
    assert all(0 <= t < 512 for t in a)


def test_launch_serve_prints_the_reference_lines(capsys):
    out = t_serve.main(["--arch", ARCH, "--reduced", "--requests", "3",
                        "--max-new", "4", "--device", "cpu"])
    text = capsys.readouterr().out.splitlines()
    assert text[0].startswith("# served 3 requests, 12 tokens at ")
    assert text[1].startswith("request 0: [") and len(text) == 4
    assert out["n_tokens"] == 12


def test_serving_defaults_to_the_card(qwen):
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServeEngine(qwen.ta)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        t_serve.main(["--reduced"])


@pytest.mark.parametrize("dtype", lf.DTYPES)
def test_fixture_contract_at_reduced_width(dtype):
    """``lm_fixture``'s path (seeded numpy weights, the port's engine, the
    hold) against the reference's loop, at the reduced width."""
    cfg = lf.config(dtype, reduced=True)
    tree = lf.param_tree(cfg)
    from repro_torch import convert
    tokens, got = lf.serve(cfg, convert.lm_params(tree, cfg, "cpu"), "cpu")
    want, _ = mk.build(dtype, tree, reduced=True)
    res = lf.hold(got, want, tokens, list(want["tokens"]), dtype)
    assert res["parted"] == [] and res["held_steps"] == \
        lf.SLOTS * lf.MAX_NEW


def test_committed_fixture_is_whole():
    cfg = lf.config("float32")
    assert cfg.d_model == 1024 and cfg.vocab_size == 151936
    for dtype in lf.DTYPES:
        tokens, want, checksum = lf.read(dtype)
        assert want["probe"].shape == (lf.SLOTS, lf.MAX_NEW, lf.N_PROBE)
        assert [len(t) for t in tokens] == [lf.MAX_NEW] * len(lf.PROMPT_LENS)
        # a request's tokens are its slot's argmaxes
        for r, t in enumerate(tokens):
            np.testing.assert_array_equal(t, want["argmax"][r])
        assert (want["margin"] >= 0).all() and checksum.shape == (4,)


def test_hold_counts_a_flip_at_a_near_tie_and_refuses_one_elsewhere():
    rng = np.random.default_rng(0)
    lg = rng.standard_normal((2, 3, 40)).astype(np.float32)
    lg[0, 1, [5, 6]] = [9.0, 8.9995]            # a near tie at slot 0 step 1
    want = lf.summarize(list(lg.transpose(1, 0, 2)), np.arange(8))
    flip = lg.copy()
    flip[0, 1, 6] = 9.0004                      # within 1e-3: a flip
    got = lf.summarize(list(flip.transpose(1, 0, 2)), np.arange(8))
    toks = [list(want["argmax"][0]), list(want["argmax"][1])]
    gtoks = [list(got["argmax"][0]), toks[1]]
    res = lf.hold(got, want, gtoks, toks, "float32")
    assert res["parted"] == [(0, 1)] and res["near_ties"] >= 1
    far = lg.copy()
    far[1, 2, :] = 0.0
    far[1, 2, 3] = 1.0                         # a different argmax, no tie
    got = lf.summarize(list(far.transpose(1, 0, 2)), np.arange(8))
    with pytest.raises(AssertionError):
        lf.hold(got, want, toks, toks, "float32")


def test_top2_margin():
    logits = np.array([[1.0, 3.0, 2.5, 3.0], [0.0, -1.0, 4.0, 1.0]],
                      np.float32)
    arg, margin = torch_parity.top2_margin(logits)
    np.testing.assert_array_equal(arg, [1, 2])
    np.testing.assert_allclose(margin, [0.0, 3.0])

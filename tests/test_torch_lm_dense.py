"""The dense LMs of the port (qwen1.5-0.5b, codeqwen1.5-7b, yi-6b,
deepseek-67b) against the reference's model functions, at the reduced
configs on the reference's own params (``tests/lm_parity.py``: rtol/atol
1e-4 on logits and caches): forward logits, prefill's last logits and
caches, and three teacher-forced decode steps; yi-6b also with the int8
cache (``tests/test_int8_cache.py``'s arch)."""
import jax  # noqa: F401  (the parity suites import both packages)
import pytest

import lm_parity as lp

ARCHS = ["qwen1.5-0.5b", "codeqwen1.5-7b", "yi-6b", "deepseek-67b"]


@pytest.fixture(scope="module", params=ARCHS)
def run(request):
    return lp.runs(request.param)


@pytest.fixture(scope="module")
def int8_run():
    return lp.runs("yi-6b", kv_cache_dtype="int8")


def test_init_tree_is_the_reference_s(run):
    lp.check_init_tree(run[0])


def test_forward_logits(run):
    lp.check_forward(*run[1:])


def test_prefill_logits_and_caches(run):
    lp.check_prefill(*run[1:])


def test_teacher_forced_decode(run):
    lp.check_decode(*run[1:])


def test_decode_matches_forward(run):
    lp.check_decode_matches_forward(run[2])


def test_int8_cache_prefill(int8_run):
    _, ref, port = int8_run
    assert port["prefill_cache"]["k"].dtype.name == "int8"
    lp.check_prefill(ref, port)


def test_int8_cache_decode(int8_run):
    lp.check_decode(*int8_run[1:])

"""The harness's look for a chip skipped, a run with the timed path broken
underneath comes out not correct, for each fault a cell can have: a step
that returns its state unchanged, one that returns its PF averages and
backlogs unchanged and the rest of its state stepped, half of the UEs
left out of the throughput, an answer altered where it is produced (the
spectral efficiency of the radio rows, 1 % high).  On the toy cell over
two ranks, the exchange between ranks left out (``core.distributed.psum``
returning the rank's own part, so the pf denominators count one shard's UEs
and the outputs are reassembled from one shard) comes out not correct too."""
import pytest

from crrm_bench_toy import manifest, result, toy_root

TOYS = ["toy_" + w["name"] for w in manifest()["workloads"]]


def _unchanged(state_in, out, tput):
    return state_in, tput


def _half_left_out(state_in, out, tput):
    tput = tput.clone()
    tput[..., tput.shape[-1] // 2:] = 0.0
    return out, tput


def _stale_pf_and_backlog(state_in, out, tput):
    return out._replace(pf_avg=state_in.pf_avg,
                        backlog=state_in.backlog), tput


FAULTS = {"unchanged": _unchanged, "half_left_out": _half_left_out,
          "stale_pf_and_backlog": _stale_pf_and_backlog}


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return toy_root(tmp_path_factory.mktemp("toy"))


def _break(monkeypatch, fault):
    from repro_torch.mac import engine
    from repro_torch.sim import radio
    if fault == "altered":
        se_chain = radio.se_chain

        def altered(cfg, gamma):
            se, cqi = se_chain(cfg, gamma)
            return se * 1.01, cqi
        monkeypatch.setattr(radio, "se_chain", altered)
        return
    make = engine.make_episode_fns

    def broken(*a, **kw):
        fns = make(*a, **kw)

        def rollout(static, state, n_tti, draws, *args, **kws):
            out = fns.rollout(static, state, n_tti, draws, *args, **kws)
            new, tput = FAULTS[fault](state, out[0], out[1])
            return (new, tput) + tuple(out[2:])
        return fns._replace(rollout=rollout)
    monkeypatch.setattr(engine, "make_episode_fns", broken)


@pytest.mark.parametrize("fault", sorted(FAULTS) + ["altered"])
@pytest.mark.parametrize("workload", TOYS)
def test_broken_path_is_not_correct(root, monkeypatch, workload, fault):
    _break(monkeypatch, fault)
    res = result(root, workload, seed=5)
    assert res["correct"] is False, res["check"]


def test_exchange_between_ranks_left_out_is_not_correct(root, monkeypatch):
    from crrm_bench_toy import _own_part, leave_out_psum
    from repro_torch.core import distributed
    monkeypatch.setattr(distributed, "psum", _own_part)
    res = result(root, "toy_uma1m_mesh2", seed=5, worker_hook=leave_out_psum)
    assert res["correct"] is False, res["check"]


def test_unbroken_path_is_correct(root):
    assert result(root, "toy_uma1m_full", seed=5)["correct"] is True

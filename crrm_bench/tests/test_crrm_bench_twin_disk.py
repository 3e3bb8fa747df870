"""The twin cell's disk writes: a checkpoint every ``ckpt_every_chunks``
chunks plus the one at t = 0, each the serving tuple's bytes, and never
more than ``keep_last`` on disk."""
import json

import pytest

from crrm_bench_toy import BENCH, result, toy_root


def test_checkpoint_bytes_follow_the_cadence(tmp_path, monkeypatch):
    every = 2
    root = toy_root(tmp_path / "root")
    from repro_torch.train import checkpoint
    write, written, kept = checkpoint._write, [], []

    def counting(ckpt_dir, step, keys, host_leaves, keep_last, extra):
        final = write(ckpt_dir, step, keys, host_leaves, keep_last, extra)
        written.append(sum(x.nbytes for x in host_leaves))
        kept.append(len(checkpoint.all_steps(ckpt_dir)))
        return final
    monkeypatch.setattr(checkpoint, "_write", counting)
    res = result(root, "toy_uma1m_twin_churn", seed=8)
    tr = json.loads((root / "crrm_bench" / "traffic" / "toy_twin_churn.json")
                    .read_text())
    assert tr["watchdog"]["ckpt_every_chunks"] == every
    chunks = tr["warmup_calls"] + res["attempted"]
    assert len(written) == 1 + chunks // every
    n = json.loads((root / "crrm_bench" / "configs" / "toy_crrm_uma_1m.json")
                   .read_text())["CRRM_parameters"]["n_ues"]
    # U 12 B, backlog / pf_avg / harq bits / harq retx / serving / ttt 4 B
    # each, active 1 B a UE; t, rr_cursor, seed, the power grid, fairness
    per_ue = 12 + 6 * 4 + 1
    assert all(per_ue * n <= b <= per_ue * n + 4096 for b in written)
    assert max(kept) <= tr["keep_last"]


def test_full_size_reckoning():
    tr = json.loads((BENCH / "traffic" / "twin_churn.json").read_text())
    # 1M UEs x 37 B = 0.0345 GiB a checkpoint, every 10 chunks of 50 TTIs
    per_ckpt = 1_000_000 * 37 / 2**30
    assert per_ckpt == pytest.approx(0.0345, rel=1e-2)
    assert tr["watchdog"]["ckpt_every_chunks"] == 10
    assert tr["keep_last"] == 2

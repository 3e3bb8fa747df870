"""The port's ``core.distributed`` against the single host.

The inputs of ``tests/test_distributed_crrm.py``: 64 UEs x 16 cells, K = 2,
UMa, on a (4, 2) mesh (``data`` x ``model``) -- here 8 gloo ranks in
subprocesses (``tests/torch_mesh.py``), each handed the global inputs as
numpy.  That test's own contract, against the port's single-host ``CRRM``
on the same roots: SINR rtol 1e-3, throughput rtol 1e-3 with atol 1
bit/s, attachment exact (the psummed interference total cancels in ``u =
total - w``, which is why the floats are held no tighter).  Against the
reference's single-host ``CRRM``, by the port's parity contract, which its
own single host needs here: attachment exact; SINR to rtol 1e-4 times the
condition number of ``w / (noise + total - w)``
(``torch_parity.assert_sinr``; at a 14 657 SINR the port's single host is
1.4e-3 off, a pathgain ulp amplified by the cancellation); throughput as
above except on a CQI step (UE 2 sits 7e-7 dB above the 1.22 dB step in
the reference and 5e-6 dB under it in the port: ``near_threshold``).
``_global_best`` breaks exact ties placed across shards to the lowest
global index, as ``jnp.argmax``.  Every rank returns the same bits.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.core.crrm import CRRM
from repro.core.params import CRRM_parameters
from torch_mesh import run_ranks, same_on_every_rank
from torch_parity import assert_sinr, near_threshold, np_, port_of

N_UE, N_CELL, K = 64, 16, 2
AXES = ("model", "data", "data+model")


def reference_case():
    k1, k2 = jax.random.split(jax.random.PRNGKey(0))
    U = jnp.concatenate([jax.random.uniform(k1, (N_UE, 2), minval=0.,
                                            maxval=3000.),
                         jnp.full((N_UE, 1), 1.5)], 1)
    C = jnp.concatenate([jax.random.uniform(k2, (N_CELL, 2), minval=0.,
                                            maxval=3000.),
                         jnp.full((N_CELL, 1), 25.)], 1)
    Pw = jnp.full((N_CELL, K), 5.0)
    params = CRRM_parameters(n_ues=N_UE, ue_positions=np.asarray(U),
                             cell_positions=np.asarray(C),
                             power_matrix=np.asarray(Pw), n_subbands=K,
                             pathloss_model_name="UMa")
    ref = CRRM(params)
    port = port_of(ref)
    want = dict(gamma=np.asarray(ref.get_SINR()),
                a=np.asarray(ref.get_attachment()),
                tput=np.asarray(ref.throughput.update()),
                w=np.asarray(ref.w.update()), u=np.asarray(ref.u.update()),
                port_gamma=np_(port.get_SINR()).copy(),
                port_tput=np_(port.throughput.update()).copy())
    R = np.asarray(ref.get_RSRP())
    idx = np.asarray([3, 17, 40], np.int32)
    new_pos = np.asarray([[10., 10., 1.5], [2900., 100., 1.5],
                          [1500., 1500., 1.5]], np.float32)
    inputs = dict(U=np.asarray(U), C=np.asarray(C), Pw=np.asarray(Pw),
                  w=want["w"], u=want["u"], a=want["a"],
                  bv=R.sum(2).max(1).astype(np.float32), idx=idx,
                  new_pos=new_pos, ties=tie_rows())
    ref.move_UEs(idx, new_pos)
    port.move_UEs(idx, new_pos)
    want.update(U2=np.asarray(ref.U._data),
                a2=np.asarray(ref.get_attachment()),
                tput2=np.asarray(ref.throughput.update()),
                gamma2=np.asarray(ref.get_SINR()),
                port_tput2=np_(port.throughput.update()).copy())
    return inputs, want, params


def tie_rows():
    """(6, 16) rows whose maxima tie within and across shards of 2, 4, 8
    and 16 columns."""
    x = np.tile(np.linspace(-3.0, -1.0, 16, dtype=np.float32), (6, 1))
    x[0] = 7.0                          # every column tied: column 0
    x[1, [3, 12]] = 5.0                 # model shards 0 and 1
    x[2, 15] = 5.0                      # the last column alone
    x[3, [5, 6]] = 5.0                  # adjacent shards of 2 columns
    x[4, [9, 10, 11]] = 5.0             # one shard of 4, two of 2
    x[5, [8, 0]] = 5.0                  # the first shard of each size
    return x


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    inputs, want, params = reference_case()
    inputs["noise"] = params.subband_noise_W
    job = dict(name="steps", inputs=inputs, noise=inputs["noise"],
               n_cells=N_CELL, bw=params.subband_bandwidth_Hz)
    outs = run_ranks(job, 8, tmp_path_factory.mktemp("steps"))
    return outs, inputs, want


def assert_tput_off_the_steps(tput, want, gamma_ref):
    """Throughput rtol 1e-3 (atol 1 bit/s) away from the CQI steps."""
    edge = near_threshold(gamma_ref)
    assert edge.mean() < 0.02, f"{edge.sum()} entries sit on a CQI step"
    np.testing.assert_allclose(tput[~edge], want[~edge], rtol=1e-3,
                               atol=1.0)


def max_rel(got, want):
    return float(np.max(np.abs(got - want) / np.maximum(np.abs(want),
                                                        1e-30)))


@pytest.mark.parametrize("maker", ["materialized", "streaming"])
def test_step_makers_match_single_host(runs, maker):
    outs, inputs, want = runs
    gamma, a, tput = outs[0][maker]
    print(f"{maker}: against the port's single host: SINR max rel err "
          f"{max_rel(gamma, want['port_gamma']):.3e}, throughput "
          f"{max_rel(tput, want['port_tput']):.3e}; against the "
          f"reference's: SINR {max_rel(gamma, want['gamma']):.3e}, "
          f"throughput {max_rel(tput, want['tput']):.3e}")
    assert a.dtype == np.int32
    np.testing.assert_array_equal(a, want["a"])
    np.testing.assert_allclose(gamma, want["port_gamma"], rtol=1e-3)
    np.testing.assert_allclose(tput, want["port_tput"], rtol=1e-3, atol=1.0)
    assert_sinr(gamma, want["gamma"], want["w"], want["u"], inputs["noise"])
    assert_tput_off_the_steps(tput, want["tput"], want["gamma"])


def test_incremental_rows_step_matches_single_host(runs):
    outs, inputs, want = runs
    U2, w2, u2, a2, bv2, tput2 = outs[0]["incremental"]
    print(f"incremental: throughput max rel err "
          f"{max_rel(tput2, want['tput2']):.3e}")
    np.testing.assert_array_equal(U2, want["U2"])
    np.testing.assert_array_equal(a2, want["a2"])
    # the carried w, u are the reference's, so UE 2 (on the CQI step) is
    # priced on the reference's side of it
    for target in (want["port_tput2"], want["tput2"]):
        assert_tput_off_the_steps(tput2, target, want["gamma2"])
    # rows nobody moved keep their carried state bit for bit
    still = np.setdiff1d(np.arange(N_UE), inputs["idx"])
    for got, old in ((w2, inputs["w"]), (u2, inputs["u"]), (a2, inputs["a"]),
                     (bv2, inputs["bv"])):
        np.testing.assert_array_equal(got[still], old[still])


@pytest.mark.parametrize("axes", AXES)
def test_global_best_breaks_ties_to_the_lowest_index(runs, axes):
    outs, inputs, _ = runs
    ties = inputs["ties"]
    for out in outs:
        gmax, a = out["best/" + axes]
        np.testing.assert_array_equal(gmax, ties.max(axis=1))
        np.testing.assert_array_equal(
            a, np.asarray(jnp.argmax(jnp.asarray(ties), axis=1)))


def test_every_rank_returns_the_same_bits(runs):
    outs, _, _ = runs
    same_on_every_rank(outs)

"""The port's pairwise-distance kernel module and kernel oracles against the
JAX package, on the CPU.

The reference runs its Pallas kernel in interpret mode
(``repro.kernels.ops.pairwise_dist``, which pads to its tiles); the port
runs ``ops.pairwise_dist`` on CPU tensors, the plain version.  Tolerances:
against the reference's kernel rtol 1e-4 / atol 0.2 m, the reference's own
allowance for its MXU expansion's cancellation (tests/test_kernels.py),
on every entry where the reference kernel itself lies within that
allowance of the float64 distance.  It does not everywhere: at short
distances in a 5 km field the cancellation exceeds 0.2 m (at seed 256 one
link of 4.187 m comes out 0.257 m short; ROADMAP queue 3).  Those entries
are counted (at most 1 %) and there the port is held to the float64
distance at rtol 1e-6.  Against the direct-subtraction oracle
``ref.pairwise_dist_ref``: rtol 1e-6 (the same float32 operation
sequence).  ``ref.fused_sinr_ref``: attachment
exact (no near ties at these seeds), w to rtol 1e-5 (log10/pow ulps), gamma
to rtol 1e-4 times its condition number (``torch_parity.assert_sinr``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as j_ops
from repro.kernels import ref as j_ref
from repro.sim import pathloss as j_pathloss
from repro_torch.kernels import ops as t_ops
from repro_torch.kernels import pairwise_dist as t_dist
from repro_torch.kernels import ref as t_ref
from repro_torch.sim import pathloss as t_pathloss
from repro_torch.sim import radio as t_radio
from torch_parity import assert_attachment, assert_sinr, np_

SHAPES = [(16, 16), (100, 37), (256, 130), (33, 257), (1, 1), (7, 3)]


def net(n, m, k=1, extent=5000.0, seed=0):
    """UE rows at 1.5 m and cells at 25 m over ``extent``, from a seed."""
    rng = np.random.default_rng(seed)
    U = np.column_stack([rng.uniform(0, extent, (n, 2)),
                         np.full(n, 1.5)]).astype(np.float32)
    C = np.column_stack([rng.uniform(0, extent, (m, 2)),
                         np.full(m, 25.0)]).astype(np.float32)
    P = rng.uniform(1.0, 10.0, (m, k)).astype(np.float32)
    return U, C, P


@pytest.mark.parametrize("n,m", SHAPES)
def test_pairwise_dist_matches_reference_kernel(n, m):
    U, C, _ = net(n, m, seed=n * m)
    d2j, d3j = j_ops.pairwise_dist(jnp.asarray(U), jnp.asarray(C), bn=32,
                                   bm=64)
    before = t_dist.pairwise_dist.launches
    d2t, d3t = t_ops.pairwise_dist(torch.as_tensor(U), torch.as_tensor(C))
    assert t_dist.pairwise_dist.launches == before     # CPU: the plain one
    U64, C64 = U.astype(np.float64), C.astype(np.float64)
    t2 = np.hypot(U64[:, None, 0] - C64[None, :, 0],
                  U64[:, None, 1] - C64[None, :, 1])
    t3 = np.hypot(t2, U64[:, None, 2] - C64[None, :, 2])
    for got, want, true in ((d2t, d2j, t2), (d3t, d3j, t3)):
        assert got.dtype == torch.float32 and tuple(got.shape) == (n, m)
        got, want = np_(got), np_(want)
        off = np.abs(want - true) > 0.2 + 1e-4 * true   # the reference's
        assert off.mean() <= 0.01, f"{off.sum()} reference entries off"
        np.testing.assert_allclose(got[~off], want[~off], rtol=1e-4,
                                   atol=0.2)
        np.testing.assert_allclose(got[off], true[off], rtol=1e-6)


@pytest.mark.parametrize("n,m", SHAPES)
def test_pairwise_dist_matches_reference_oracle(n, m):
    U, C, _ = net(n, m, seed=n + m)
    d2j, d3j = j_ref.pairwise_dist_ref(jnp.asarray(U), jnp.asarray(C))
    Ut, Ct = torch.as_tensor(U), torch.as_tensor(C)
    d2t, d3t = t_ops.pairwise_dist(Ut, Ct)
    np.testing.assert_allclose(np_(d2t), np_(d2j), rtol=1e-6)
    np.testing.assert_allclose(np_(d3t), np_(d3j), rtol=1e-6)
    # the plain version is the port's D block without the bearing
    d2r, d3r = t_ref.pairwise_dist_ref(Ut, Ct)
    d2c, d3c, _ = t_radio.compute_distances(Ut, Ct)
    assert torch.equal(d2t, d2r) and torch.equal(d2t, d2c)
    assert torch.equal(d3t, d3r) and torch.equal(d3t, d3c)


def test_pairwise_dist_is_exact_where_the_mxu_form_cancels():
    """Two points 1 m apart at the far corner of a 5 km field: the direct
    form keeps the metre, the reference kernel's expansion may not."""
    U = torch.tensor([[4999.0, 4999.0, 1.5]])
    C = torch.tensor([[4998.0, 4999.0, 1.5]])
    d2, d3 = t_ops.pairwise_dist(U, C)
    assert float(d2) == 1.0 and float(d3) == 1.0


def test_pairwise_dist_checks_inputs_and_routes_cuda_to_the_kernel(
        monkeypatch):
    U, C, _ = net(4, 3)
    Ut, Ct = torch.as_tensor(U), torch.as_tensor(C)
    with pytest.raises(TypeError, match="float32"):
        t_dist.pairwise_dist(Ut.double(), Ct)
    with pytest.raises(ValueError, match=r"\(n, 3\)"):
        t_dist.pairwise_dist(Ut[:, :2].contiguous(), Ct)
    with pytest.raises(ValueError, match="contiguous"):
        t_dist.pairwise_dist(torch.as_tensor(np.asfortranarray(U)), Ct)

    class FakeCuda:
        device = torch.device("cuda")

    called = []
    monkeypatch.setattr(t_dist, "_launch", lambda *a: called.append("k"))
    monkeypatch.setattr(t_dist, "pairwise_dist_plain",
                        lambda *a: called.append("plain"))
    t_dist.pairwise_dist(FakeCuda(), None)
    assert called == ["k"]

    class Meta:
        device = torch.device("meta")

    with pytest.raises(ValueError, match="CUDA or CPU"):
        t_dist.pairwise_dist(Meta(), None)


@pytest.mark.parametrize("model", ["power_law", "UMa", "RMa", "InH"])
@pytest.mark.parametrize("n,m,k", [(64, 32, 1), (100, 67, 3)])
def test_fused_sinr_ref_matches_reference(model, n, m, k):
    U, C, P = net(n, m, k, seed=7)
    noise = 1e-12
    jm = j_pathloss.make_pathloss(model)
    gj, aj, wj, uj = j_ref.fused_sinr_ref(jnp.asarray(U), jnp.asarray(C),
                                          jnp.asarray(P), jm.get_pathgain,
                                          noise)
    gt, at, wt, ut = t_ref.fused_sinr_ref(
        torch.as_tensor(U), torch.as_tensor(C), torch.as_tensor(P),
        t_pathloss.make_pathloss(model), noise)
    d2, d3, _ = t_radio.compute_distances(torch.as_tensor(U),
                                          torch.as_tensor(C))
    g = jm.get_pathgain(jnp.asarray(np_(d2)), jnp.asarray(np_(d3)),
                        jnp.asarray(C[None, :, 2]), jnp.asarray(U[:, None, 2]))
    assert_attachment(at, aj, np_(g) * P.sum(axis=1)[None, :])
    np.testing.assert_allclose(np_(wt), np_(wj), rtol=1e-5)
    assert_sinr(gt, gj, wj, uj, noise)

"""The port's fused-kernel module against the JAX package, on the CPU.

The reference runs its Pallas kernel in interpret mode
(``repro.kernels.ops.fused_sinr(..., interpret=True)``) with small tiles,
so its padding of ragged edges is exercised; the port runs
``fused_sinr_accumulate_plain`` and ``ops.fused_sinr`` on CPU tensors (the
route the fused backend takes for CPU tensors).  Tolerances: total and w
to rtol 1e-4 (sum order and log10/pow ulps; the contract of
tests/test_kernel_vs_crrm.py); u to 1e-4 of the total (it is a
difference); gamma to rtol 1e-4 times its condition number
(``torch_parity.assert_sinr``); attachment exact with no near ties at these
seeds.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as j_ops
from repro.sim import pathloss as j_pathloss
from repro_torch.kernels import fused_sinr as t_fused
from repro_torch.kernels import ops as t_ops
from repro_torch.sim import pathloss as t_pathloss
from torch_parity import assert_sinr, near_tie_rows, np_

RTOL = 1e-4
NOISE_W = 1e-13
MODELS = {
    "RMa": dict(fc_GHz=0.7), "RMa_constant_height": dict(fc_GHz=0.7),
    "RMa_discretised": dict(fc_GHz=0.7), "UMa": dict(), "UMi": dict(),
    "InH": dict(), "power_law": dict(alpha=3.5)}


def inputs(n, m, k, fading, seed, n_sectors=1, h_bs=25.0, extent=2000.0):
    rng = np.random.default_rng(seed)
    U = np.column_stack([rng.uniform(0, extent, (n, 2)),
                         rng.uniform(1.0, 2.5, (n, 1))]).astype(np.float32)
    n_sites = max(1, m // n_sectors)
    sites = np.column_stack([rng.uniform(0, extent, (n_sites, 2)),
                             np.full((n_sites, 1), h_bs)])
    C = np.repeat(sites, n_sectors, axis=0)[:m].astype(np.float32)
    P = rng.uniform(1.0, 10.0, (m, k)).astype(np.float32)
    bore = ((np.arange(m) % n_sectors) * (2 * np.pi / n_sectors)).astype(
        np.float32)
    fad = {None: None,
           "wide": rng.exponential(1.0, (n, m)).astype(np.float32),
           "rb": rng.exponential(1.0, (n, m, k)).astype(np.float32)}[fading]
    return U, C, P, bore, fad


def run_both(U, C, P, bore, fad, name, n_sectors, attach_on_mean,
             noise_w=NOISE_W):
    jm = j_pathloss.make_pathloss(name, **MODELS[name])
    tm = t_pathloss.make_pathloss(name, **MODELS[name])
    if name == "RMa_discretised":
        # the Pallas kernel cannot trace this model (its LUTs would be
        # captured constants), so the reference is its materialised chain
        ref = reference_chain(U, C, P, bore, fad, jm, n_sectors,
                              attach_on_mean, noise_w)
    else:
        ref = j_ops.fused_sinr(
            jnp.asarray(U), jnp.asarray(C), jnp.asarray(P), pathgain_fn=jm,
            noise_w=noise_w, boresight=jnp.asarray(bore),
            fad=None if fad is None else jnp.asarray(fad),
            attach_on_mean=attach_on_mean, n_sectors=n_sectors, bn=16, bm=8,
            interpret=True)
    t = lambda x: None if x is None else torch.as_tensor(x)
    got = t_ops.fused_sinr(t(U), t(C), t(P), pathgain_fn=tm, noise_w=noise_w,
                           boresight=t(bore), fad=t(fad),
                           attach_on_mean=attach_on_mean, n_sectors=n_sectors)
    return ref, got


def reference_chain(U, C, P, bore, fad, model, n_sectors, attach_on_mean,
                    noise_w):
    """(gamma, a, w, u) through the reference's materialised radio chain."""
    from repro.sim import radio as j_radio
    from repro.sim.antenna import Antenna_gain
    cfg = j_radio.RadioConfig(model, Antenna_gain(), n_sectors, noise_w, 1,
                              1, 1, 1, False, True, False, 1.0)
    G0 = j_radio.pathgains(cfg, jnp.asarray(U), jnp.asarray(C),
                           jnp.asarray(bore))
    G = G0 if fad is None else j_radio.apply_fading(G0, jnp.asarray(fad))
    R = j_radio.rsrp(G, jnp.asarray(P))
    a = j_radio.attachment(j_radio.rsrp(G0, jnp.asarray(P))
                           if attach_on_mean else R)
    gamma, w, u = j_radio.sinr(R, a, noise_w)
    return gamma, a, w, u


def check(ref, got, meas_ref):
    g_r, a_r, w_r, u_r = (np_(x) for x in ref)
    g_t, a_t, w_t, u_t = (np_(x) for x in got)
    assert near_tie_rows(meas_ref).sum() == 0
    assert a_t.dtype == np.int32
    np.testing.assert_array_equal(a_t, a_r)
    np.testing.assert_allclose(w_t, w_r, rtol=RTOL)
    total = w_r + u_r
    assert_sinr(g_t, g_r, w_r, u_r, NOISE_W, rtol=RTOL)
    assert (np.abs(u_t - u_r) <= RTOL * total).all()


def reference_meas(U, C, P, bore, fad, name, n_sectors, attach_on_mean):
    """The reference's wideband measurement, for the near-tie count."""
    from repro.sim import radio as j_radio
    from repro.sim.antenna import Antenna_gain
    cfg = j_radio.RadioConfig(j_pathloss.make_pathloss(name, **MODELS[name]),
                              Antenna_gain(), n_sectors, 0.0, 1, 1, 1, 1,
                              False, True, False, 1.0)
    g = j_radio.pathgains(cfg, jnp.asarray(U), jnp.asarray(C),
                          jnp.asarray(bore))
    if fad is not None and not attach_on_mean:
        g = j_radio.apply_fading(g, jnp.asarray(fad))
    return np_(j_radio.rsrp(g, jnp.asarray(P)).sum(axis=2))


@pytest.mark.parametrize("name", sorted(MODELS))
def test_fused_sinr_matches_reference_per_pathloss_model(name):
    """Every pathloss model, unfaded, omni, N and M off the tile grid."""
    h_bs = 35.0 if name.startswith("RMa") else 25.0
    args = inputs(37, 13, 2, None, seed=sorted(MODELS).index(name), h_bs=h_bs)
    ref, got = run_both(*args, name, 1, False)
    check(ref, got, reference_meas(*args, name, 1, False))


@pytest.mark.parametrize("fading,attach_on_mean",
                         [(None, False), ("wide", False), ("wide", True),
                          ("rb", False), ("rb", True)])
@pytest.mark.parametrize("n_sectors", [1, 3])
def test_fused_sinr_matches_reference_fading_and_sectors(
        fading, attach_on_mean, n_sectors):
    k = 4 if fading == "rb" else 1
    args = inputs(45, 21, k, fading, seed=11 + n_sectors, n_sectors=n_sectors)
    ref, got = run_both(*args, "UMa", n_sectors, attach_on_mean)
    check(ref, got, reference_meas(*args, "UMa", n_sectors, attach_on_mean))


def test_plain_accumulator_layout_matches_reference():
    """The raw accumulator: shapes, dtypes and values of all four outputs."""
    from repro.kernels import fused_sinr as j_fused
    U, C, P, bore, fad = inputs(16, 8, 2, "rb", seed=5)
    jm, tm = j_pathloss.UMa_pathloss(), t_pathloss.UMa_pathloss()
    ref = j_fused.fused_sinr_accumulate(
        jnp.asarray(U), jnp.asarray(C), jnp.asarray(P),
        jnp.asarray(bore)[:, None], jnp.asarray(fad), pathgain_fn=jm, bn=8,
        bm=8, interpret=True)
    got = t_fused.fused_sinr_accumulate_plain(
        *(torch.as_tensor(x) for x in (U, C, P, bore, fad)), pathgain_fn=tm)
    for r, g in zip(ref, got):
        assert tuple(g.shape) == r.shape
        assert np_(g).dtype == np_(r).dtype
        np.testing.assert_allclose(np_(g), np_(r), rtol=RTOL)


def test_tie_goes_to_the_lowest_cell_index():
    """Two co-located equal-power cells: both packages serve from the
    lower index."""
    U = np.array([[100.0, 0.0, 1.5], [0.0, 300.0, 1.5]], np.float32)
    C = np.array([[0.0, 0.0, 25.0], [500.0, 0.0, 25.0], [0.0, 0.0, 25.0]],
                 np.float32)
    P = np.full((3, 1), 5.0, np.float32)
    bore = np.zeros(3, np.float32)
    ref, got = run_both(U, C, P, bore, None, "UMa", 1, False)
    assert np_(ref[1]).tolist() == [0, 0]
    assert np_(got[1]).tolist() == [0, 0]


def test_wrapper_checks_inputs_and_counts_only_kernel_launches():
    U, C, P, bore, _ = (torch.as_tensor(x) if x is not None else None
                        for x in inputs(8, 4, 1, None, seed=0))
    before = t_fused.fused_sinr_accumulate.launches
    t_fused.fused_sinr_accumulate(U, C, P, bore,
                                  pathgain_fn=t_pathloss.UMa_pathloss())
    # a CPU tensor runs the plain version, which is not a launch
    assert t_fused.fused_sinr_accumulate.launches == before
    with pytest.raises(TypeError):
        t_fused.fused_sinr_accumulate(U.double(), C, P, bore,
                                      pathgain_fn=t_pathloss.UMa_pathloss())
    with pytest.raises(ValueError, match="shape"):
        t_fused.fused_sinr_accumulate(U, C, P[:2], bore,
                                      pathgain_fn=t_pathloss.UMa_pathloss())
    with pytest.raises(ValueError, match="attach_on_mean"):
        t_fused.fused_sinr_accumulate(U, C, P, bore, attach_on_mean=True,
                                      pathgain_fn=t_pathloss.UMa_pathloss())


def test_every_model_describes_itself_to_the_kernel():
    """Kernel ids are distinct per formula family and parameter tuples
    fit the kernel's parameter block."""
    ids = set()
    for name, kw in MODELS.items():
        model_id, params = t_pathloss.make_pathloss(name, **kw).kernel_spec()
        assert all(isinstance(v, float) for v in params)
        assert len(params) <= 64
        ids.add(model_id)
    assert len(ids) == 6   # constant-height RMa shares the RMa formulas


# ---------------------------------------------------------------------------
# The kernel's folded arithmetic, evaluated in float64 from kernel_spec()
# ---------------------------------------------------------------------------
S_DB = 0.1 * np.log2(10.0)
PHI3 = 1.1344640137963142


def kernel_log2gain(model_id, v, dx, dy, dz, h_bs, h_ut):
    """log2 gain of each link as ``csrc/fused_sinr.cu`` computes it (its
    per-family formulas, from the folded ``kernel_spec`` parameters)."""
    q2 = dx * dx + dy * dy
    q3 = q2 + dz * dz
    L3 = np.log2(np.maximum(q3, 1e-18))
    lg2 = lambda x, lo: np.log2(np.maximum(x, lo))
    if model_id == t_pathloss.PL_POWER_LAW:
        return v[0] * lg2(q3 * v[1], 1e-18)
    if model_id == t_pathloss.PL_INH:
        lg = v[0] + v[1] * L3
        return lg if v[2] else np.minimum(lg, v[3] + v[4] * L3)
    if model_id in (t_pathloss.PL_UMA, t_pathloss.PL_UMI):
        dbp = (h_bs - 1.0) * (v[0] * (h_ut - 1.0))
        bp2 = np.where(dbp >= 0, dbp * dbp, -1.0)
        c2 = v[3] + v[5] * lg2(dbp * dbp + (h_bs - h_ut) ** 2, 1e-9)
        lg = np.where(q2 <= bp2, v[1] + v[2] * L3, c2 + v[4] * L3)
        return lg if v[6] else np.minimum(lg, v[7] + v[9] * h_ut + v[8] * L3)
    if model_id == t_pathloss.PL_RMA:
        if v[5]:
            h_bs, h_ut = np.full_like(h_bs, v[6]), np.full_like(h_ut, v[7])
        dbp = v[0] * h_bs * h_ut
        bp2 = np.where(dbp >= 0, dbp * dbp, -1.0)
        c2 = v[1] + 2 * v[2] * lg2(dbp, 1e-9) + v[3] * dbp + 4 * lg2(dbp, 1.0)
        lg = np.where(q2 <= bp2, v[1] + v[2] * L3 + v[3] * np.sqrt(q3),
                      c2 - 2 * L3)
        if v[4]:
            return lg
        lhb = np.log10(np.maximum(h_bs, 1e-9))
        B = 43.42 - 3.1 * lhb
        kcell = v[8] - S_DB * (-(24.37 - 3.7 * (v[9] / h_bs) ** 2) * lhb
                               - 3 * B)
        lu = np.log10(np.maximum(11.75 * h_ut, 1e-9))
        return np.minimum(lg, kcell + 3.2 * S_DB * lu * lu - 0.05 * B * L3)
    assert model_id == t_pathloss.PL_RMA_DISCRETISED
    H = int(v[7])
    k = np.clip(np.rint((h_ut - v[4]) / v[5]).astype(int), 0, H - 1)
    dbp, c2, cn = (np.asarray(v[8 + i::3])[k] for i in range(3))
    bp2 = np.where(dbp >= 0, dbp * dbp, -1.0)
    lg = np.where(q2 <= bp2, v[0] + v[1] * L3 + v[2] * np.sqrt(q3),
                  c2 - 2 * L3)
    return lg if v[3] else np.minimum(lg, cn + v[6] * L3)


def kernel_sector_log2gain(dx, dy, bore):
    """The kernel's sector attenuation: off wrapped by 2 pi rint(off / 2 pi)."""
    off = np.arctan2(dy, dx) - bore
    off = off - 2 * np.pi * np.rint(off / (2 * np.pi))
    return np.maximum(-S_DB * 12.0 / PHI3 ** 2 * off * off, -S_DB * 30.0)


def algebra_links(h_bs):
    """Links on both sides of every breakpoint, UE heights below 1 m
    included, and the two exact breakpoint-ratio neighbourhoods."""
    rng = np.random.default_rng(17)
    n = 4000
    d2d = np.exp(rng.uniform(np.log(5.0), np.log(20000.0), n))
    az = rng.uniform(-np.pi, np.pi, n)
    h_ut = np.concatenate([rng.uniform(1.0, 2.5, n - 400),
                           rng.uniform(0.3, 0.99, 400)])
    # links just inside and just outside the UMa/UMi and RMa breakpoints
    d_bp = np.concatenate([4 * (h_bs - 1) * (h_ut[:200] - 1) * 3.5e9
                           / 299_792_458.0,
                           2 * np.pi * h_bs * h_ut[:200] * 0.7e9
                           / 299_792_458.0])
    d2d[:400] = d_bp * np.where(np.arange(400) % 2, 1.001, 0.999)
    return d2d * np.cos(az), d2d * np.sin(az), h_bs - h_ut, h_ut


@pytest.mark.parametrize("los", [False, True])
@pytest.mark.parametrize("name", sorted(MODELS))
def test_kernel_folded_pathgain_matches_model(name, los, monkeypatch):
    """The kernel's log2-gain form of every model, from its kernel_spec()
    constants, equals the model's plain gain in float64 to rtol 1e-6.  The
    model's scalar terms are taken in float64 too: in the package they
    round in float32, as the reference's weakly typed scalars do, which by
    itself moves a gain by ~1e-6."""
    monkeypatch.setattr(t_pathloss, "_log10", lambda x: torch.log10(
        torch.clamp(torch.as_tensor(x, dtype=torch.float64), min=1e-9)))
    kw = dict(MODELS[name])
    if name != "power_law":
        kw["LOS"] = los
    model = t_pathloss.make_pathloss(name, **kw)
    h_bs = 35.0 if name.startswith("RMa") else 25.0
    dx, dy, dz, h_ut = algebra_links(h_bs)
    model_id, v = model.kernel_spec()
    hb = np.full_like(h_ut, h_bs)
    got = np.exp2(kernel_log2gain(model_id, v, dx, dy, -dz, hb, h_ut))
    t = lambda x: torch.as_tensor(x, dtype=torch.float64)
    d2d = np.sqrt(dx * dx + dy * dy)
    d3d = np.sqrt(d2d * d2d + dz * dz)
    want = np_(model(t(d2d), t(d3d), t(hb), t(h_ut)))
    assert (h_ut < 1.0).any() and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=1e-6)


def test_kernel_sector_wrap_matches_atan2_wrap():
    """off - 2 pi rint(off / 2 pi) against atan2(sin, cos): equal
    attenuation everywhere, at off = +-pi and for boresights past 2 pi."""
    rng = np.random.default_rng(3)
    az = np.concatenate([rng.uniform(-np.pi, np.pi, 5000),
                         [np.pi, -np.pi, 0.0, np.pi / 2]])
    dx, dy = np.cos(az) * 300.0, np.sin(az) * 300.0
    dx[-4:-2], dy[-4:-2] = -300.0, [0.0, -0.0]          # off = +pi, -pi
    for bore in (0.0, 2 * np.pi / 3, 4 * np.pi / 3, 7.5, -9.0):
        got = np.exp2(kernel_sector_log2gain(dx, dy, bore))
        off = np.arctan2(dy, dx) - bore
        off = np.arctan2(np.sin(off), np.cos(off))
        want = 10.0 ** (-0.1 * np.minimum(12.0 * (off / PHI3) ** 2, 30.0))
        np.testing.assert_allclose(got, want, rtol=1e-6)
    assert np.arctan2(dy[-4], dx[-4]) == np.pi
    assert np.arctan2(dy[-3], dx[-3]) == -np.pi


# ---------------------------------------------------------------------------
# Dirty rows by index
# ---------------------------------------------------------------------------
IDX = np.array([5, 0, 17, 5, 33, 2, 2, 2, 40, 11, 29, 8, 8, 36, 1, 5],
               np.int64)                   # 16 rows, with repeats


@pytest.mark.parametrize("idx_dtype", [np.int32, np.int64])
@pytest.mark.parametrize("fading,attach_on_mean",
                         [(None, False), ("wide", True), ("rb", False)])
def test_plain_accumulator_by_index_matches_reference(fading, attach_on_mean,
                                                      idx_dtype):
    """The plain version reading rows ``idx`` (with repeats) equals the
    reference kernel, in interpret mode, on the gathered rows."""
    from repro.kernels import fused_sinr as j_fused
    k = 3 if fading == "rb" else 1
    # the reference's raw accumulator takes whole tiles: 16 rows, 24 cells
    U, C, P, bore, fad = inputs(41, 24, k, fading, seed=23, n_sectors=3)
    idx = IDX.astype(idx_dtype)
    jm, tm = j_pathloss.UMa_pathloss(), t_pathloss.UMa_pathloss()
    ref = j_fused.fused_sinr_accumulate(
        jnp.asarray(U[idx]), jnp.asarray(C), jnp.asarray(P),
        jnp.asarray(bore)[:, None],
        None if fad is None else jnp.asarray(fad[idx]), pathgain_fn=jm,
        n_sectors=3, attach_on_mean=attach_on_mean, bn=8, bm=8,
        interpret=True)
    t = lambda x: None if x is None else torch.as_tensor(x)
    got = t_fused.fused_sinr_accumulate(
        t(U), t(C), t(P), t(bore), t(fad), idx=t(idx), pathgain_fn=tm,
        n_sectors=3, attach_on_mean=attach_on_mean)
    assert got[0].shape == (len(idx), k)
    assert near_tie_rows(reference_meas(U[idx], C, P, bore,
                                        None if fad is None else fad[idx],
                                        "UMa", 3, attach_on_mean)).sum() == 0
    np.testing.assert_array_equal(np_(got[2]), np_(ref[2]))
    for r, g in zip(ref, got):
        np.testing.assert_allclose(np_(g), np_(r), rtol=RTOL)


def test_ops_fused_sinr_by_index_matches_reference_rows():
    """ops.fused_sinr(idx=...) equals the reference entry point on the
    gathered rows: gamma, attachment, w and u."""
    U, C, P, bore, fad = inputs(50, 13, 2, "rb", seed=31)
    idx = IDX
    ref = j_ops.fused_sinr(
        jnp.asarray(U[idx]), jnp.asarray(C), jnp.asarray(P),
        pathgain_fn=j_pathloss.UMi_pathloss(), noise_w=NOISE_W,
        boresight=jnp.asarray(bore), fad=jnp.asarray(fad[idx]), bn=8, bm=8,
        interpret=True)
    t = torch.as_tensor
    got = t_ops.fused_sinr(t(U), t(C), t(P),
                           pathgain_fn=t_pathloss.UMi_pathloss(),
                           noise_w=NOISE_W, boresight=t(bore), fad=t(fad),
                           idx=t(idx))
    check(ref, got, reference_meas(U[idx], C, P, bore, fad[idx], "UMi", 1,
                                   False))


def test_wrapper_rejects_bad_index():
    U, C, P, bore, fad = (torch.as_tensor(x) for x in
                          inputs(8, 4, 1, "wide", seed=0))
    kw = dict(pathgain_fn=t_pathloss.UMa_pathloss())
    run = lambda idx: t_fused.fused_sinr_accumulate(U, C, P, bore, fad,
                                                    idx=idx, **kw)
    with pytest.raises(TypeError, match="int32 or int64"):
        run(torch.tensor([0.0, 1.0]))
    with pytest.raises(TypeError, match="int32 or int64"):
        run(torch.tensor([0, 1], dtype=torch.int16))
    with pytest.raises(ValueError, match="shape"):
        run(torch.zeros((2, 1), dtype=torch.int32))
    with pytest.raises(ValueError, match="meta"):
        run(torch.zeros(2, dtype=torch.int32, device="meta"))
    with pytest.raises(ValueError, match="range"):
        run(torch.tensor([0, 8], dtype=torch.int32))
    with pytest.raises(ValueError, match="range"):
        run(torch.tensor([-1, 3], dtype=torch.int64))
    total, *_ = run(torch.tensor([7, 7, 0], dtype=torch.int32))
    assert total.shape == (3, 1) and torch.equal(total[0], total[1])


def test_group_size_is_a_built_lane_group():
    """Every launch takes GROUP; the other lane groups are built for UMa and
    UMi at K <= 4 only, and the launch refuses any other before it builds
    or launches anything."""
    assert t_fused.GROUP in t_fused.GROUP_SIZES
    rng = np.random.default_rng(0)
    U = torch.as_tensor(rng.uniform(0, 500, (6, 3)), dtype=torch.float32)
    C = torch.as_tensor(rng.uniform(0, 500, (4, 3)), dtype=torch.float32)
    bore = torch.zeros(4)
    for model, k, group in ((t_pathloss.RMa_pathloss(), 1, 16),
                            (t_pathloss.UMa_pathloss(), 8, 16),
                            (t_pathloss.UMi_pathloss(), 1, 12),
                            (t_pathloss.InH_pathloss(), 4, 32)):
        with pytest.raises(ValueError, match="not built"):
            t_fused._launch(U, C, torch.ones(4, k), bore, pathgain_fn=model,
                            group=group)

"""Smoke run of the PyTorch port on one CUDA card: build, check, measure.

    python3 chip_smoke.py

Phases, each printing its own lines:

1. device  -- the card's name, the device count and its power limit;
2. build   -- the nvcc build of every kernel source, its seconds and the
              ptxas register / shared-memory / spill lines;
3. kernel  -- each kernel against its plain PyTorch version on the card, at
              small ragged shapes and at the main path's full widths, with
              CUDA-event times beside the plain version's and the bound;
4. pairwise -- the pairwise-distance kernel against its plain version at
              ragged shapes and at the full width of the million-UE
              field's D block (1M UEs x 127 cells), driven once through
              its entry point ``kernels.ops.pairwise_dist``; CUDA-event
              times of the kernel, the plain version and ``torch.cdist``
              beside the byte bound;
5. forward -- ``radio_forward(backend="fused")`` against the materialised
              chain at 100 000 UEs;
6. episode -- the main path: the million-UE incremental episode through the
              fused kernel, its launch count per TTI, ms/TTI, peak memory
              and a torch.profiler breakdown of one TTI; then dense vs
              incremental at 100 000 UEs on the same draws;
7. env     -- ``CrrmEnv`` on the ``dense_urban_twin`` preset at 100 000 UEs
              with telemetry: reset, steps to ``done`` (ms per env step),
              a ``fairness_p`` step, the KPI summary; telemetry on vs off,
              two resets of one seed and ``step_autoreset`` held equal
              bit for bit (in PyTorch's deterministic mode, so that the
              atomics of ``index_add_`` add in a fixed order); one
              ``resample_topology`` reset.

Each path (pairwise, episode, env) sets every kernel's launch count to 0
just before it and reads the counts just after.  The line before the last
is the JSON of the kernels, the last line the JSON of the device.  Any
disagreement raises, and the script exits non-zero.  Without a CUDA device
it exits non-zero before printing any result.
"""
from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

H100_FP32_OPS = 67e12        # float32 outside the tensor cores, op/s
H100_BYTES = 3.35e12         # HBM3, bytes/s
RTOL = 1e-4                  # total / w_best / gamma contract
RTOL_DIST = 1e-6             # pairwise distances: the same rounded ops
TIE_RTOL = 1e-5              # attachment near-tie margin

# float32 operations per link of the kernel, one per arithmetic op or
# transcendental call, as written in csrc/fused_sinr.cu
OPS_DIST = 11                # 3 sub, 4 mul, 2 add, 2 sqrt
# sector: atan2, sub, sin, cos, atan2, div, 2 mul, min, sub, mul, pow
OPS_SECTOR = 12
OPS_MODEL = {0: 60, 1: 30, 2: 36, 3: 36, 4: 16, 5: 3}   # pathloss + pow
OPS_PER_K = 6                # fading mul, power mul, 2 adds, mean mul-add
OPS_ARGMAX = 1


def log(phase, msg):
    print(f"[{phase}] {msg}", flush=True)


def launch_counts():
    """{kernel: launches} of every kernel wrapper of the port."""
    from repro_torch.kernels import fused_sinr as fk
    from repro_torch.kernels import pairwise_dist as pdk
    return {"fused_sinr": fk.fused_sinr_accumulate.launches,
            "pairwise_dist": pdk.pairwise_dist.launches}


def zero_counts():
    from repro_torch.kernels import fused_sinr as fk
    from repro_torch.kernels import pairwise_dist as pdk
    fk.fused_sinr_accumulate.launches = 0
    pdk.pairwise_dist.launches = 0


def cuda_ms(fn, reps=20, warm=3):
    """Mean device time of ``fn`` in ms over ``reps`` warm calls."""
    for _ in range(warm):
        fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound_ms(n, m, k, fad, model_id, n_sectors):
    """The least time of one fused_sinr call on these inputs: the larger of
    its bytes over the memory rate and its operations over the fp32 rate."""
    in_bytes = 4 * (3 * n + 3 * m + m * k + m)
    if fad is not None:
        in_bytes += 4 * fad.numel()
    out_bytes = 4 * (2 * n * k + 2 * n)
    ops = n * m * (OPS_DIST + OPS_MODEL[model_id] + k * OPS_PER_K
                   + OPS_ARGMAX + (OPS_SECTOR if n_sectors > 1 else 0))
    t_bytes = (in_bytes + out_bytes) / H100_BYTES * 1e3
    t_ops = ops / H100_FP32_OPS * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes > t_ops else "operations")


def phase_device():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke run needs one",
              file=sys.stderr)
        sys.exit(2)
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    log("device", f"{name}; device count {torch.cuda.device_count()}; "
        f"torch {torch.__version__} CUDA {torch.version.cuda}")
    log("device", f"nvidia-smi: {smi}")
    return name, smi


def phase_build():
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    libs = build.load_all()            # one nvcc per source, all at once
    log("build", f"{len(libs)} sources built in "
        f"{time.perf_counter() - t0:.2f} s")
    for name, (_, info) in libs.items():
        log("build", f"{name}.cu: {info.seconds:.2f} s -> {info.path.name}")
        for line in info.log.splitlines():
            if any(w in line for w in ("registers", "spill", "smem",
                                       "Compiling entry")):
                log("build", "  " + line.strip())


def make_inputs(n, m, k, fading, seed, n_sectors=1, h_bs=25.0,
                extent=2000.0):
    g = torch.Generator(device="cuda").manual_seed(seed)
    u = lambda *s: torch.rand(s, generator=g, device="cuda")
    U = torch.cat([u(n, 2) * extent, 1.0 + 1.5 * u(n, 1)], dim=1)
    n_sites = max(1, m // n_sectors)
    sites = torch.cat([u(n_sites, 2) * extent,
                       torch.full((n_sites, 1), h_bs, device="cuda")], dim=1)
    C = torch.repeat_interleave(sites, n_sectors, dim=0)[:m].contiguous()
    P = 1.0 + 9.0 * u(m, k)
    bore = ((torch.arange(m, device="cuda") % n_sectors).float()
            * (2 * math.pi / n_sectors))
    fad = None
    if fading == "wide":
        fad = torch.empty(n, m, device="cuda").exponential_(generator=g)
    elif fading == "rb":
        fad = torch.empty(n, m, k, device="cuda").exponential_(generator=g)
    return U, C, P, bore, fad


def near_tie_mask(U, C, P, bore, fad, model, n_sectors, attach_on_mean):
    from repro_torch.sim import radio
    cfg = radio.RadioConfig(model, radio.Antenna_gain(), n_sectors, 0.0, 1, 1,
                            1, 1, False, True, False, 1.0)
    g = radio.pathgains(cfg, U, C, bore)
    if fad is not None and not attach_on_mean:
        g = radio.apply_fading(g, fad)
    top2 = torch.topk(radio.rsrp(g, P).sum(dim=2), 2, dim=1).values
    return (top2[:, 0] - top2[:, 1]) < TIE_RTOL * top2[:, 0]


def check_kernel(args, model, n_sectors, attach_on_mean):
    """The kernel against its plain version; returns (max abs err of total,
    max rel err, near ties)."""
    from repro_torch.kernels import fused_sinr as fk
    U, C, P, bore, fad = args
    kw = dict(pathgain_fn=model, n_sectors=n_sectors,
              attach_on_mean=attach_on_mean)
    total, bval, bidx, wbest = fk.fused_sinr_accumulate(U, C, P, bore, fad,
                                                        **kw)
    torch.cuda.synchronize()
    t_p, v_p, i_p, w_p = fk.fused_sinr_accumulate_plain(U, C, P, bore, fad,
                                                        **kw)
    ties = near_tie_mask(U, C, P, bore, fad, model, n_sectors, attach_on_mean)
    n_ties = int(ties.sum())
    if n_ties > max(1, U.shape[0] // 100):
        raise AssertionError(f"{n_ties} near-tie rows of {U.shape[0]}")
    ok = ~ties
    if not torch.equal(bidx[ok], i_p[ok]):
        bad = int((bidx[ok] != i_p[ok]).sum())
        raise AssertionError(f"attachment differs on {bad} rows")
    rel = 0.0
    for got, want in ((total, t_p), (bval, v_p), (wbest[ok], w_p[ok])):
        err = ((got - want).abs() / want.abs().clamp(min=1e-30)).max()
        rel = max(rel, float(err))
    if rel > RTOL:
        raise AssertionError(f"kernel vs plain rel err {rel:.3e} > {RTOL}")
    return float((total - t_p).abs().max()), rel, n_ties


def phase_kernel():
    from repro_torch.kernels import fused_sinr as fk
    from repro_torch.sim import pathloss
    models = {"RMa": dict(fc_GHz=0.7), "RMa_constant_height": dict(fc_GHz=0.7),
              "RMa_discretised": dict(fc_GHz=0.7), "UMa": {}, "UMi": {},
              "InH": {}, "power_law": dict(alpha=3.5)}
    n_cases = 0
    for i, (name, kw) in enumerate(sorted(models.items())):
        model = pathloss.make_pathloss(name, **kw)
        h_bs = 35.0 if name.startswith("RMa") else 25.0
        for fading, aom in ((None, False), ("wide", False), ("wide", True),
                            ("rb", False), ("rb", True)):
            for n_sectors in (1, 3):
                args = make_inputs(1000, 57, 4 if fading == "rb" else 1,
                                   fading, seed=i, n_sectors=n_sectors,
                                   h_bs=h_bs)
                _, rel, ties = check_kernel(args, model, n_sectors, aom)
                n_cases += 1
        log("kernel", f"{name}: 10 ragged cases (N=1000, M=57) agree; "
            f"last rel err {rel:.2e}, near ties {ties}")
    log("kernel", f"{n_cases} ragged cases agree with the plain version")

    # full widths: the main path's shape (K=1, no fading) and per-RB K=4
    uma = pathloss.UMa_pathloss()
    rows = {}
    for label, k, fading in (("main", 1, None), ("rb4", 4, "rb")):
        args = make_inputs(100_000, 127, k, fading, seed=7, extent=8000.0)
        abs_err, rel, ties = check_kernel(args, uma, 1, False)
        U, C, P, bore, fad = args
        kw = dict(pathgain_fn=uma)
        ms = cuda_ms(lambda: fk.fused_sinr_accumulate(U, C, P, bore, fad,
                                                      **kw))
        plain = cuda_ms(lambda: fk.fused_sinr_accumulate_plain(
            U, C, P, bore, fad, **kw), reps=5, warm=1)
        b_ms, b_by = bound_ms(100_000, 127, k, fad, uma.kernel_spec()[0], 1)
        rows[label] = dict(ms=ms, plain_ms=plain, bound_ms=b_ms,
                           bound_by=b_by, max_abs_err=abs_err)
        log("kernel", f"N=100000 M=127 K={k} fading={fading}: kernel "
            f"{ms:.4f} ms, plain {plain:.4f} ms, bound {b_ms:.4f} ms "
            f"({b_by}); max abs err {abs_err:.3e} W, max rel err "
            f"{rel:.2e}, near ties {ties}")
    return rows


def dist_errors(got, want):
    """(max abs err in metres, max rel err) of (d2d, d3d) pairs."""
    abs_err = max(float((g - w).abs().max()) for g, w in zip(got, want))
    rel_err = max(float(((g - w).abs() / w.abs().clamp(min=1e-30)).max())
                  for g, w in zip(got, want))
    return abs_err, rel_err


def phase_pairwise(smi):
    """The pairwise-distance kernel: ragged parity, then its path at the
    million-UE field's full width and its times there."""
    from repro_torch.core.crrm import CRRM
    from repro_torch.core.params import CRRM_parameters
    from repro_torch.kernels import ops
    from repro_torch.kernels import pairwise_dist as pdk
    for n, m in ((1, 1), (7, 3), (33, 257), (1000, 57), (100_000, 127)):
        g = torch.Generator(device="cuda").manual_seed(n + m)
        U = torch.rand((n, 3), generator=g, device="cuda") * torch.tensor(
            [5000.0, 5000.0, 1.5], device="cuda")
        C = torch.rand((m, 3), generator=g, device="cuda") * torch.tensor(
            [5000.0, 5000.0, 25.0], device="cuda")
        got = pdk.pairwise_dist(U, C)
        torch.cuda.synchronize()
        abs_err, rel_err = dist_errors(got, pdk.pairwise_dist_plain(U, C))
        log("pairwise", f"N={n} M={m}: max abs err {abs_err:.3e} m, max rel "
            f"err {rel_err:.3e}")
        if rel_err > RTOL_DIST:
            raise AssertionError(f"pairwise_dist vs plain rel err "
                                 f"{rel_err:.3e} > {RTOL_DIST}")
    # the D block of the million-UE field: the episode's own UEs and cells
    sim = CRRM(CRRM_parameters(n_ues=1_000_000, n_cells=127, n_sectors=1,
                               seed=3))
    U, C = sim.U._data.contiguous(), sim.C._data.contiguous()
    n, m = U.shape[0], C.shape[0]
    del sim
    # -- the path: counts to 0 just before, read just after ---------------
    zero_counts()
    d2d, d3d = ops.pairwise_dist(U, C)
    torch.cuda.synchronize()
    counts = launch_counts()
    log("pairwise", f"path ops.pairwise_dist at N={n} M={m}: launches "
        f"{counts}")
    if counts["pairwise_dist"] != 1:
        raise AssertionError(f"pairwise_dist path launched {counts}")
    if d2d.shape != (n, m) or not (torch.isfinite(d2d).all()
                                   and torch.isfinite(d3d).all()):
        raise AssertionError("non-finite or misshapen distances")
    plain = pdk.pairwise_dist_plain(U, C)
    abs_err, rel_err = dist_errors((d2d, d3d), plain)
    if rel_err > RTOL_DIST:
        raise AssertionError(f"pairwise_dist vs plain at full width: rel "
                             f"err {rel_err:.3e}")
    lib = (torch.cdist(U[:, :2], C[:, :2]), torch.cdist(U, C))
    lib_abs, lib_rel = dist_errors(lib, plain)
    del lib, plain, d2d, d3d
    ms = cuda_ms(lambda: pdk.pairwise_dist(U, C), reps=20)
    plain_ms = cuda_ms(lambda: pdk.pairwise_dist_plain(U, C), reps=20)
    library_ms = cuda_ms(lambda: (torch.cdist(U[:, :2], C[:, :2]),
                                  torch.cdist(U, C)), reps=20)
    # the least time: each input read once, both outputs written once
    b_ms = (8 * n * m + 12 * (n + m)) / H100_BYTES * 1e3
    o_ms = n * m * OPS_DIST / H100_FP32_OPS * 1e3
    bound, by = (b_ms, "bytes") if b_ms >= o_ms else (o_ms, "operations")
    log("pairwise", f"N={n} M={m} ({smi}): kernel {ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms, torch.cdist x2 {library_ms:.4f} ms, bound "
        f"{bound:.4f} ms ({by}); kernel vs plain max abs err {abs_err:.3e} "
        f"m (rel {rel_err:.2e}); cdist vs plain max abs err {lib_abs:.3e} m "
        f"(rel {lib_rel:.2e})")
    return dict(launches=counts["pairwise_dist"], max_abs_err=abs_err,
                ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by=by,
                library_ms=library_ms)


def phase_forward():
    from repro_torch.core.crrm import CRRM
    from repro_torch.core.params import CRRM_parameters
    from repro_torch.kernels import fused_sinr as fk
    from repro_torch.sim import phy, radio
    configs = {
        "UMa 100000 x 127": CRRM_parameters(
            n_ues=100_000, n_cells=127, n_sectors=1, seed=3,
            pathloss_model_name="UMa", power_W=10.0),
        "dense_urban widened to 100000": CRRM_parameters(
            n_ues=100_000, n_cells=21, n_sectors=3, extent_m=1200.0,
            pathloss_model_name="UMi", fc_GHz=3.5, h_bs_m=10.0, power_W=6.3,
            rayleigh_fading=True, n_rb_subbands=4, coherence_rb=3, seed=0),
    }
    thr = phy.table("CQI_SINR_THRESHOLDS_DB", torch.device("cuda"))
    for label, p in configs.items():
        sim = CRRM(p)
        rs, U, fad = sim.radio_static(), sim.U._data, sim.fading._data
        want = radio.radio_forward(rs, U, fad=fad)
        fk.fused_sinr_accumulate.launches = 0
        got = radio.radio_forward(rs, U, fad=fad, backend="fused")
        torch.cuda.synchronize()
        launched = fk.fused_sinr_accumulate.launches
        if launched != 1:
            raise AssertionError(f"fused forward launched {launched} kernels")
        cfg = rs.cfg
        G0 = radio.pathgains(cfg, U, rs.C, rs.bore)
        use = G0 if (cfg.rayleigh_fading and cfg.attach_ignores_fading) \
            else radio.apply_fading(G0, fad)
        top2 = torch.topk(radio.rsrp(use, rs.P).sum(dim=2), 2, dim=1).values
        ties = (top2[:, 0] - top2[:, 1]) < TIE_RTOL * top2[:, 0]
        bad_a = int((got.a != want.a)[~ties].sum())
        db = phy.sinr_to_db(want.gamma)
        edge = ((db[..., None] - thr).abs() < 1e-4).any(dim=-1)
        edge = edge | ties[:, None]
        bad_c = int((got.cqi != want.cqi)[~edge].sum())
        bad_s = int((got.se != want.se)[~edge].sum())
        log("forward", f"{label}: fused vs torch: attachment differs on "
            f"{bad_a} rows (near ties {int(ties.sum())}); cqi/se differ on "
            f"{bad_c}/{bad_s} entries off the CQI steps ({int(edge.sum())} "
            f"on a step or tie)")
        if bad_a or bad_c or bad_s:
            raise AssertionError(f"forward {label}: fused disagrees")
        if not (torch.isfinite(got.gamma).all() and got.a.shape == (p.n_ues,)):
            raise AssertionError("non-finite or misshapen forward output")
        del sim, rs, U, fad, want, got, G0, use


def per_tti_ms(fns, static, state, draws):
    """Host-clock ms per TTI: (rollout of 6 TTIs - rollout of 1) / 5."""
    times = {}
    for n in (1, 6):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fns.rollout(static, state, n, draws)
        torch.cuda.synchronize()
        times[n] = time.perf_counter() - t0
    return (times[6] - times[1]) / 5 * 1e3


def profiled(fn):
    """(wall seconds, {kernel: (device us, launches)}) of one ``fn()`` under
    ``torch.profiler``, synchronised at both ends."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = {}
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", 0.0)
        if us > 0 and e.device_type == torch.autograd.DeviceType.CUDA:
            kernels[e.key] = (us, e.count)
    return wall, kernels


def log_breakdown(phase, unit, wall_us, per, top=8):
    """Device busy/idle share and the heaviest kernels of one ``unit``."""
    busy_us = sum(us for us, _ in per.values())
    launches = sum(c for _, c in per.values())
    log(phase, f"profiled {unit}: wall {wall_us / 1e3:.3f} ms under the "
        f"profiler, device busy {busy_us / 1e3:.3f} ms "
        f"({100 * busy_us / wall_us:.1f} %), idle "
        f"{100 * (1 - busy_us / wall_us):.1f} %, {launches:.0f} kernel "
        f"launches per {unit}")
    for name, (us, cnt) in sorted(per.items(), key=lambda kv: -kv[1][0])[:top]:
        log(phase, f"  {us:9.1f} us/{unit}  x{cnt:4.0f}  {name[:90]}")


def device_breakdown(fns, static, state, draws):
    """Per-TTI device busy time, kernel launches and the heaviest kernels:
    a rollout of 6 TTIs minus a rollout of 1, which cancels the set-up (the
    full-width RadioState init)."""
    w1, k1 = profiled(lambda: fns.rollout(static, state, 1, draws))
    w6, k6 = profiled(lambda: fns.rollout(static, state, 6, draws))
    per = {name: ((us - k1.get(name, (0.0, 0))[0]) / 5,
                  (cnt - k1.get(name, (0.0, 0))[1]) / 5)
           for name, (us, cnt) in k6.items()}
    log_breakdown("episode", "TTI", (w6 - w1) / 5 * 1e6, per)


def phase_episode():
    from repro_torch.core.crrm import CRRM
    from repro_torch.core.params import CRRM_parameters
    from repro_torch.kernels import fused_sinr as fk
    from repro_torch.mac.engine import Draws
    kw = dict(n_cells=127, n_sectors=1, seed=3, pathloss_model_name="UMa",
              power_W=10.0, scheduler_policy="pf", fairness_p=0.5,
              mobility_step_m=20.0, mobility_move_frac=0.1)
    n_tti = 5
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    sim = CRRM(CRRM_parameters(n_ues=1_000_000, radio_mode="incremental",
                               **kw))
    fns = sim.episode_fns(inc_backend="fused")
    static, state = sim.episode_static(), sim.init_episode_state()
    torch.cuda.synchronize()
    log("episode", f"1M x 127 set-up (graph + first query) "
        f"{time.perf_counter() - t0:.2f} s")
    draws = Draws(3, "cuda")
    # -- the main path: counts to 0 just before, read just after ----------
    torch.cuda.synchronize()
    zero_counts()
    t0 = time.perf_counter()
    out_state, tput = fns.rollout(static, state, n_tti, draws)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launch_counts()
    launches = counts["fused_sinr"]
    log("episode", f"main path: launches {counts} over {n_tti} TTIs; "
        f"rollout incl. RadioState init {wall:.3f} s")
    if launches != n_tti:
        raise AssertionError(f"expected {n_tti} kernel launches, got "
                             f"{launches}")
    if tput.shape != (n_tti, 1_000_000) or not torch.isfinite(tput).all():
        raise AssertionError("non-finite or misshapen episode throughput")
    for f in ("U", "backlog", "pf_avg"):       # full buffer: backlog is inf
        if torch.isnan(getattr(out_state, f)).any():
            raise AssertionError(f"NaN in the episode state {f}")
    ms = per_tti_ms(fns, static, state, draws)
    peak = torch.cuda.max_memory_allocated() / 2**30
    log("episode", f"1M x 127 incremental fused: {ms:.3f} ms/TTI "
        f"(host clock, synchronised), peak device memory {peak:.2f} GiB, "
        f"mean served {float(tput.mean()) / 1e6:.4f} Mbit/s/UE")
    device_breakdown(fns, static, state, draws)
    del sim, fns, static, state, out_state, tput
    torch.cuda.empty_cache()

    # -- dense (torch) vs incremental (fused) on the same draws ------------
    outs, times = {}, {}
    for mode, be in (("dense", "torch"), ("incremental", "fused")):
        sim = CRRM(CRRM_parameters(n_ues=100_000, radio_mode=mode, **kw))
        fns = sim.episode_fns(inc_backend=be)
        static, state = sim.episode_static(), sim.init_episode_state()
        _, outs[mode] = fns.rollout(static, state, n_tti, Draws(3, "cuda"))
        times[mode] = per_tti_ms(fns, static, state, Draws(3, "cuda"))
        del sim, fns, static, state
    dense, inc = outs["dense"], outs["incremental"]
    rel = float((inc - dense).abs().max() / dense.abs().max().clamp(min=1.0))
    log("episode", f"100000 x 127: dense (torch) {times['dense']:.3f} "
        f"ms/TTI, incremental (fused) {times['incremental']:.3f} ms/TTI, "
        f"max rel err {rel:.3e}")
    if rel > RTOL:
        raise AssertionError(f"incremental deviates from dense: {rel:.3e}")
    return launches


def env_step_ms(env, state, action, fairness_p=None):
    """One env step timed on the host clock, synchronised at both ends."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = env.step(state, action, fairness_p)
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def leaves_equal(a, b):
    return all((x is None and y is None) or torch.equal(x, y)
               for x, y in zip(a, b))


def phase_env():
    """CrrmEnv on dense_urban_twin at 100 000 UEs, with telemetry."""
    from repro_torch.env import CrrmEnv
    from repro_torch.obs import format_summary, summarize
    kw = dict(scenario="dense_urban_twin",
              scenario_overrides={"n_ues": 100_000}, tti_per_step=5,
              episode_tti=10)
    t0 = time.perf_counter()
    env = CrrmEnv(telemetry=True, **kw)
    torch.cuda.synchronize()
    log("env", f"dense_urban_twin at 100000 UEs x {env.n_cells} cells: "
        f"set-up {time.perf_counter() - t0:.2f} s")
    act = env.uniform_action()
    # -- the env path: counts to 0 just before, read just after -----------
    torch.cuda.synchronize()
    zero_counts()
    state, _ = env.reset(0)
    step_ms, telems = [], []
    done = False
    while not done:
        (state, obs, reward, done, info), ms = env_step_ms(env, state, act)
        done = bool(done)
        step_ms.append(ms)
        telems.append(info["telemetry"])
    state_f, _ = env.reset(1)
    (_, obs_f, reward_f, _, info_f), ms_f = env_step_ms(env, state_f, act,
                                                        fairness_p=0.2)
    torch.cuda.synchronize()
    counts = launch_counts()
    log("env", f"path: launches {counts}; ms per env step (5 TTIs) "
        + ", ".join(f"{ms:.3f}" for ms in step_ms)
        + f"; with fairness_p=0.2 {ms_f:.3f}; reward {float(reward):.4f}, "
        f"with fairness_p {float(reward_f):.4f}")
    if not (torch.isfinite(obs.tput).all() and obs.tput.shape == (100_000,)
            and len(step_ms) == 2):
        raise AssertionError("env: non-finite or misshapen observation")
    from repro_torch.obs.telemetry import Telemetry
    stacked = Telemetry(*(None if v[0] is None else torch.cat(v)
                          for v in zip(*telems)))
    log("env", "KPIs over the episode:\n" + format_summary(
        summarize(stacked, tti_s=env.params.tti_s)))
    if int(stacked.dirty_rows[0]) != round(0.1 * env.n_ues):
        raise AssertionError("env: dirty rows are not 10 % of the UEs")
    wall, per = profiled(lambda: env.step(env.reset(0)[0], act))
    log_breakdown("env", "step", wall * 1e6, per)

    # -- equalities, in deterministic mode (index_add_ in a fixed order) --
    del env
    torch.use_deterministic_algorithms(True)
    try:
        env = CrrmEnv(telemetry=True, **kw)
        env_off = CrrmEnv(telemetry=False, **kw)
        runs = []
        for e in (env, env_off, env):
            s, _ = e.reset(0)
            out = e.step(s, act)
            runs.append(out)
        (s_on, o_on, *_, i_on), (s_off, o_off, *_), (s_on2, *_, i_on2) = runs
        if not (torch.equal(o_on.tput, o_off.tput)
                and leaves_equal(s_on, s_off)):
            raise AssertionError("env: telemetry changed the trajectory")
        if not leaves_equal(i_on["telemetry"], i_on2["telemetry"]):
            raise AssertionError("env: two resets of one seed differ")
        s, _ = env.reset(0)
        s = env.step(s, act)[0]
        s_ar, _, _, done, _ = env.step_autoreset(s, act, reset_seed=5)
        fresh, _ = env.reset(5)
        if not (bool(done) and leaves_equal(s_ar, fresh)):
            raise AssertionError("env: step_autoreset did not restart")
    finally:
        torch.use_deterministic_algorithms(False)
    log("env", "telemetry on/off bit-equal; two resets of one seed give "
        "equal telemetry; step_autoreset restarts at done")
    del env, env_off, runs
    env_r = CrrmEnv(resample_topology=True, **kw)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state_r, _ = env_r.reset(3)
    torch.cuda.synchronize()
    ms_r = (time.perf_counter() - t0) * 1e3
    if not (torch.isfinite(state_r.static.se).all()
            and state_r.ep.U.shape == (100_000, 3)):
        raise AssertionError("env: bad resampled reset")
    log("env", f"resample_topology reset at 100000 UEs: {ms_r:.3f} ms")
    del env_r, state_r
    torch.cuda.empty_cache()
    return step_ms


def main():
    name, smi = phase_device()
    phase_build()
    rows = phase_kernel()
    dist = phase_pairwise(smi)
    phase_forward()
    launches = phase_episode()
    phase_env()
    main_row = rows["main"]
    kernels = [{
        "name": "fused_sinr", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/fused_sinr.cu",
        "replaces": "src/repro/kernels/fused_sinr.py:139",
        "launches": launches, "max_abs_err": main_row["max_abs_err"],
        "ms": main_row["ms"], "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["bound_ms"], "bound_by": main_row["bound_by"],
        "library_ms": None}, {
        "name": "pairwise_dist", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/pairwise_dist.cu",
        "replaces": "src/repro/kernels/pairwise_dist.py:41", **dist}]
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()

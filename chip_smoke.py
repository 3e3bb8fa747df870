"""Smoke run of the PyTorch port on one CUDA card: build, check, measure.

    python3 chip_smoke.py

Phases, each printing its own lines:

1. device  -- the card's name, the device count and its power limit;
2. build   -- the nvcc build of every kernel source, its seconds and the
              ptxas register / shared-memory / spill lines;
3. kernel  -- each kernel against its plain PyTorch version on the card, at
              small ragged shapes and at the main path's full widths, with
              CUDA-event times beside the plain version's and the bound;
4. forward -- ``radio_forward(backend="fused")`` against the materialised
              chain at 100 000 UEs;
5. episode -- the main path: the million-UE incremental episode through the
              fused kernel, its launch count per TTI, ms/TTI, peak memory
              and a torch.profiler breakdown of one TTI; then dense vs
              incremental at 100 000 UEs on the same draws.

The line before the last is the JSON of the kernels, the last line the JSON
of the device.  Any disagreement raises, and the script exits non-zero.
Without a CUDA device it exits non-zero before printing any result.
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
    for src in sorted(build.CSRC.glob("*.cu")):
        _, info = build.load(src.stem)
        log("build", f"{src.name}: {info.seconds:.2f} s -> {info.path.name}")
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


def device_breakdown(fns, static, state, draws, top=8):
    """Per-TTI device busy time, kernel launches and the heaviest kernels,
    from ``torch.profiler``: a rollout of 6 TTIs minus a rollout of 1, which
    cancels the set-up (the full-width RadioState init)."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    runs = {}
    for n in (1, 6):
        torch.cuda.synchronize()
        with profile(activities=acts) as prof:
            t0 = time.perf_counter()
            fns.rollout(static, state, n, draws)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        kernels = {}
        for e in prof.key_averages():
            us = getattr(e, "self_device_time_total", 0.0)
            if us > 0 and e.device_type == torch.autograd.DeviceType.CUDA:
                kernels[e.key] = (us, e.count)
        runs[n] = (wall, kernels)
    (w1, k1), (w6, k6) = runs[1], runs[6]
    per = {name: ((us - k1.get(name, (0.0, 0))[0]) / 5,
                  (cnt - k1.get(name, (0.0, 0))[1]) / 5)
           for name, (us, cnt) in k6.items()}
    busy_us = sum(us for us, _ in per.values())
    launches = sum(c for _, c in per.values())
    wall_us = (w6 - w1) / 5 * 1e6
    log("episode", f"profiled TTI: wall {wall_us / 1e3:.3f} ms under the "
        f"profiler, device busy {busy_us / 1e3:.3f} ms "
        f"({100 * busy_us / wall_us:.1f} %), idle "
        f"{100 * (1 - busy_us / wall_us):.1f} %, {launches:.0f} kernel "
        f"launches per TTI")
    for name, (us, cnt) in sorted(per.items(), key=lambda kv: -kv[1][0])[:top]:
        log("episode", f"  {us:9.1f} us/TTI  x{cnt:4.0f}  {name[:90]}")


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
    fk.fused_sinr_accumulate.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out_state, tput = fns.rollout(static, state, n_tti, draws)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = fk.fused_sinr_accumulate.launches
    log("episode", f"main path: fused_sinr launches {launches} over "
        f"{n_tti} TTIs; rollout incl. RadioState init {wall:.3f} s")
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


def main():
    name, smi = phase_device()
    phase_build()
    rows = phase_kernel()
    phase_forward()
    launches = phase_episode()
    main_row = rows["main"]
    kernels = [{
        "name": "fused_sinr", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/fused_sinr.cu",
        "replaces": "src/repro/kernels/fused_sinr.py:139",
        "launches": launches, "max_abs_err": main_row["max_abs_err"],
        "ms": main_row["ms"], "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["bound_ms"], "bound_by": main_row["bound_by"],
        "library_ms": None}]
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()

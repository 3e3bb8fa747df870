"""Smoke run of the PyTorch port on one CUDA card: build, check, measure.

    python3 chip_smoke.py

Phases, each printing its own lines:

1. device  -- the card's name, the device count and its power limit;
2. build   -- the nvcc build of every kernel source, its seconds and the
              ptxas register / shared-memory / spill lines;
3. kernel  -- fused_sinr against its plain PyTorch version on the card: 70
              ragged cases over every pathloss model and fading mode; exact
              ties across lanes; ragged M and N at every lane-group size G;
              then the full-width rows main, rb4, sect3, small and idx_rb4
              (rows read by index from a 1M-row field), each with CUDA-event
              times at every G beside the plain version's and the bound, the
              max relative error of the per-link gain, the attachment held
              to a float64 argmax, and for the unfaded rows the
              special-function pipe's time at the SM clock; then the times
              of every G at M = 300 and 600;
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
              and a breakdown of one TTI from the package's trace
              (``repro_torch.obs.profile``); then dense vs
              incremental at 100 000 UEs on the same draws;
7. env     -- ``CrrmEnv`` on the ``dense_urban_twin`` preset at 100 000 UEs
              with telemetry: reset, steps to ``done`` (ms per env step),
              a ``fairness_p`` step, the KPI summary; telemetry on vs off,
              two resets of one seed and ``step_autoreset`` held equal
              bit for bit (in PyTorch's deterministic mode, so that the
              atomics of ``index_add_`` add in a fixed order); one
              ``resample_topology`` reset;
8. churn   -- the million-UE episode of phase 6 under birth-death churn
              (the twin bench's ratios): newborn rows join the mover rows
              in one fused_sinr index, so one launch per TTI; active UEs
              and dirty rows per TTI, ms/TTI with and without churn, peak
              memory and a profile of one TTI; then dense (torch) vs
              incremental (fused) under churn at 100 000 UEs;
9. faults  -- the same episode under ``outage_storm``'s fault process:
              ``inc_backend="auto"`` resolves to the torch rows (printed
              with its reason; its re-pricing takes ``reprice_cells``,
              phase 21) and ``"fused"`` raises; cells down and
              reattachments per TTI, ms/TTI with and without faults, peak
              memory, how often a cell changes state, a profile of one
              TTI; dense vs incremental at 100 000 UEs on ``"torch"``
              (max error within RTOL) and on ``"auto"`` (throughput share
              off within ``TPUT_OFF_SHARE``), and the CQI steps the
              kernel's re-pricing flips in that rollout; the
              ``outage_storm`` env at 100 000 UEs to ``done`` with its KPIs;
10. batch  -- ``CrrmEnv`` on ``dense_urban_twin`` at 100 000 UEs with
              B = 8 seeds: ``reset_batch``, ``step_batch`` to ``done`` and
              one ``step_autoreset_batch``; ms per batched step beside 8
              single steps, launches per TTI of each; row b against
              ``reset(seed_b)`` + ``step`` in deterministic mode (bit for
              bit, or within rtol 1e-6 with the leaves that differ named);
              one ``resample_topology`` batched reset;
11. twin   -- a watchdog-armed ``TwinServer`` over the million-UE churn
              episode (``inc_backend="fused"``, chunks of 50 TTIs, a
              checkpoint after every chunk): fused_sinr launches per chunk
              (50), ms per chunk guarded and not and the parts of one chunk,
              the seconds of a blocking save, of save_async's caller block
              and of a restore, peak memory, active UEs; a kill and restore
              re-served bit for bit in deterministic mode; an injected NaN,
              a raised chunk and a timed-out chunk recovered on
              ``"fused"``; then the reference bench's twin arm (20 000 x 57
              dense: ms/TTI of serving beside the churn-free rollout);
12. chaos  -- ``repro_torch.robust.chaos.drill`` at ``outage_storm`` with
              100 000 UEs, incremental ``inc_backend="auto"`` (the faults
              and handover take the torch rows, and the drill says so): the
              recovery time of each injection in healthy chunks, the
              history lines and ``CHAOS_OK``;
13. diffopt -- the differentiable engine (``relax=``): the finite-
              difference check of ``tests/test_rl.py`` on the reference's
              own inputs (``tests/relax_fixture.py``, 12 UEs x 8 TTIs, both
              scenarios, deterministic mode, best relative error <= 1e-3);
              ``optimize_power_plan``'s defaults on ``dense_urban`` at its
              preset width (200 UEs x 21 cells, 4 segments x 10 TTIs, 40
              steps): soft and hard Mbit/s at step 0 and at the end, ms per
              gradient step (forward and backward) and per hard scoring;
              the power objective's gradient at that width on the
              reference's drop and draws (deterministic mode), held to the
              reference's ``jax.grad`` over the 2 TTIs both programs share
              (value rtol 1e-5, g.v rtol 1e-4, every element within 1e-4 *
              max|g|, FD <= 1e-3) and printed beside the reference's over
              the 40 TTIs of the timed step, where a one-ulp drained-backlog
              residue parts the programs; then 100 000 UEs x 2 segments x 5
              TTIs: the reckoned autograd memory, ms per gradient step and
              peak memory;
14. ppo    -- ``train_power_baseline("dense_urban")`` at ``BENCH_rl.json``'s
              recipe (12 UEs, 80 iterations): ``best_uplift`` and
              ``final_uplift`` beside the reference's CPU record 1.1468 and
              its gate 1.05 (printed, not held), ms per iteration split
              into collection and update; 2 iterations at 100 000 UEs with
              ``PPOConfig``'s defaults (n_envs 8, n_steps 16): ms per
              iteration, kernel launches per collected TTI, peak memory;
              then 2 iterations + checkpoint + restore + 2 held equal to 4
              bit for bit in deterministic mode;
15. mesh   -- ``core.distributed`` on the one card, ranks started with
              ``torch.multiprocessing`` (spawn), every group with a
              timeout and every rank joined against a deadline: (1) the
              million-UE episode on a 1-rank NCCL ("ue",) mesh, bit for
              bit against the plain rollout in deterministic mode, one
              fused_sinr launch per TTI, ms/TTI beside phase 6's; then
              gloo ranks sharing the card with CUDA tensors (NCCL refuses
              two ranks on one GPU): (2) BENCH_sharded's 100 000 x 19 pf
              episode, 50 TTIs, on a UE mesh of 2, held to 1e-5 of one
              device in deterministic mode (also printed with the atomics
              in no fixed order, beside two single-device runs), rr and
              max_cqi bitwise; (3) the million-UE episode on a UE mesh of
              2, one fused_sinr launch per rank per TTI; (4) phase 3's
              sect3 field as an engine (100 000 x 126, A3, dense) on UE x
              cell meshes (1, 2) and (2, 2), and the fused route's
              refusal; (5) the three step makers on (1, 2) at 100 000 x
              126, K = 2, against the single-device CRRM.  Times of ranks
              sharing one card are a record, not a scaling;
16. report -- the package's own observability: ``obs.report.episode_report``
              over phase 6's million-UE episode (``"fused"``, 5 TTIs): its
              roofline row, analytic flops and bytes, device and wall ms
              per TTI from the package's trace, fused_sinr launches (1 per
              TTI); a ``trace`` of one TTI with ``annotate`` spans
              prepare / rollout / sync, its Chrome trace read back for the
              spans and the fused_sinr kernel, and a ``StageTimer`` report
              of the same; then the three crrm-ppp cells through
              ``launch.dryrun.run_crrm_cell`` on a 1-rank NCCL group (peak
              GiB beside the reckoned, device ms, roofline row, the cell
              tile where it was cut), each held to the materialised step on
              sampled rows (attachment exact off near ties, SINR within
              1e-5 x kappa), and net_256k against the streaming step on the
              same field (throughput too).  Artifacts go under
              ``artifacts/dryrun/``;
17. serve  -- the LM serving path (``repro_torch.serve.engine``): qwen1.5-0.5b
              at full width on ``tests/lm_fixture.py``'s seeded weights,
              in bfloat16 and in float32, held to the reference's greedy
              run (logits within 0.25 / 1e-3 while a slot's inputs agree,
              tokens exact off counted top-2 near ties); ``python -m
              repro_torch.launch.serve``'s defaults through its entry
              point, then timed through ``ServeEngine`` (tok/s, ms per
              prefill and per decode step, peak memory); one decode step
              under the package's trace beside its byte bound (the f32
              params read once); 32 slots x 512-token prompts x 64 new;
              every LM config whose f32 params fit the card served whole
              (2 x 8 tokens, finite, greedy runs equal), the others' bytes
              reckoned on the meta device;
18. train  -- the LM training path (``repro_torch.train``): qwen1.5-0.5b at
              full width on the seeded weights, 3 AdamW steps in float32
              and bfloat16 held to the reference's run
              (``tests/lm_train_fixture.py``: losses, gradient probes,
              params off counted sign flips); flash's memory-exact
              backward at seq 4096 against the naive gradient, both
              peaks; ``python -m repro_torch.launch.train`` for 30 steps
              with a checkpoint, the loop's resume to 40 against an
              uninterrupted 40 in deterministic mode; the bf16 8 x 2048
              arm (ms per step, tok/s, peak, the model-flops bound, one
              profiled step); one step of each other config whose AdamW
              state fits the card, the rest reckoned on the meta device;
              seamless-m4t-large-v2 served whole;
19. mesh_lm -- the LM meshes (``repro_torch.parallel``, ZeRO-3 training
              through ``train.loop.train(mesh=)``): qwen1.5-0.5b at full
              width on the seeded weights, 3 AdamW steps of 2 x 128 on a
              1-rank NCCL (1, 1) mesh in float32 and bfloat16, held to the
              reference's *sharded* run (``tests/lm_mesh_fixture.py``:
              losses rtol 1e-5 / 2e-2), the bfloat16 run beside the port's
              unsharded run (bit for bit or not, in deterministic mode:
              printed); then
              2 gloo ranks sharing the card with CUDA tensors on (2, 1)
              and (1, 2) meshes in float32 ((1, 2) computing
              tensor-parallel on ``model``), losses within rtol 1e-5 of
              the 1-rank run, per rank the peak memory beside the
              reckoned per-rank state, collective calls and wire bytes per
              step beside the storage-only model axis's and ms per step
              (a record: the ranks share one card); zamba2-1.2b at full
              width, 2 SGD steps of 2 x 128 on (1, 2) (tensor-parallel
              Mamba-2 layers), held to its 1-rank NCCL run: losses rtol
              1e-5, the step-1 gradient's norm leaf by leaf and whole
              within ``HYBRID_GRAD_RTOL``; then ``launch.dryrun
              --arch qwen1.5-0.5b --all --both-meshes``: each cell's
              reckoned GiB per device and analytic flops, and its
              one-device reckoning against the card's memory;
20. serve_mesh -- serving on a mesh (``ServeEngine(arch, mesh)``,
              tensor-parallel on ``model``): qwen1.5-0.5b at full width on
              the fixture's weights on a 1-rank NCCL (1, 1) mesh in
              bfloat16 and float32, held to the reference's fixture as
              phase 17 is; then 2 gloo ranks sharing the card on (1, 2):
              qwen in float32 held to the 1-rank run (tokens off counted
              near ties, logits rtol 1e-4), granite-moe-1b-a400m at full
              width (16 experts a rank) and reduced yi-6b at ``max_len``
              8192 (its cache's sequence on ``model``) each held to the
              port's unsharded engine on the card, then falcon-mamba-7b
              and zamba2-1.2b at full width (tensor-parallel Mamba
              layers) held to the unsharded engine run alone first; per
              rank the peak
              beside the reckoned params + cache, all-reduces and wire
              bytes per decode step, ms per prefill and per decode step.
              Alone: ``python -c "import chip_smoke as c; n, smi =
              c.phase_device(); c.phase_serve_mesh(smi)"``;
21. reprice -- (run after phase 9) the fault re-pricing kernel
              ``reprice_cells`` against its plain version on the million-UE
              field's carried gain (1M x 127) under a power with ~13 % dark
              and ~8 % sleeping cells: the attachment bit for bit, gamma
              within its summation-order bound, the CQI steps it flips,
              the kernel, plain and bound ms and the kernel's ptxas line;
              launches per TTI of a storm rollout (1) and of a fault-free
              one (0); the storm rollout on ``"auto"`` (the kernel) against
              ``"torch"``: fault states and serving cells equal, the
              throughput share off within ``TPUT_OFF_SHARE``, and ms per
              TTI of each.  Alone: ``python -c "import chip_smoke as
              c; n, smi = c.phase_device(); c.phase_reprice(smi)"``.

Each path (pairwise, episode, env, churn, faults, batch, twin, diffopt,
ppo, each mesh run in its own rank, the report, serve, train, mesh_lm and
serve_mesh) sets every kernel's launch count to 0 just before it and reads
the counts just after; phases 13, 14 and 17-20 launch no kernel (the
relaxed chain is the torch one: fused_sinr has no backward; the LM path
has no hand-written kernel) and fail if one launched.  The line before the last
is the JSON of the kernels, the last line the JSON of the device.  Any
disagreement raises, and the script exits non-zero.  Without a CUDA device
it exits non-zero before printing any result.
"""
from __future__ import annotations

import json
import math
import os
import re
import subprocess
import sys
import threading
import time
import types
from pathlib import Path

# cuBLAS's deterministic workspace, read when its handles are made: the
# deterministic-mode phases run matmuls (the LM training resume)
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

RTOL = 1e-4                  # total / w_best / gamma contract
#: the million-UE episode of phases 6, 8 and 9 (benchmarks/paper_benches.py)
EPISODE = dict(n_cells=127, n_sectors=1, seed=3, pathloss_model_name="UMa",
               power_W=10.0, scheduler_policy="pf", fairness_p=0.5,
               mobility_step_m=20.0, mobility_move_frac=0.1)
#: the twin bench's churn ratios: 0.35 x capacity arrivals per second, a
#: 2 s mean lifetime, capacity // 512 births per TTI at most
#: (benchmarks/paper_benches.py:721-722)
CHURN_1M = dict(arrival_rate_hz=350_000.0, mean_lifetime_s=2.0,
                max_arrivals_per_tti=1953)
CHURN_100K = dict(arrival_rate_hz=35_000.0, mean_lifetime_s=2.0,
                  max_arrivals_per_tti=195)
#: outage_storm's fault process (sim/scenarios.py)
STORM = dict(outage_rate_hz=5.0, mean_outage_s=0.03, sleep_rate_hz=5.0,
             mean_sleep_s=0.02, sleep_atten_db=10.0)
RTOL_DIST = 1e-6             # pairwise distances: the same rounded ops
TIE_RTOL = 1e-5              # attachment near-tie margin
#: share of (TTI, UE) throughputs off by more than RTOL that a route which
#: sums the cell total in another order may leave (crrm_bench's
#: ``tput_off_share`` limit of ``uma1m_storm``)
TPUT_OFF_SHARE = 0.01

# Hopper's special-function pipe: log2 / exp2 / reciprocal results per clock
# per SM, and the SMs of an H100 SXM
SFU_PER_CLOCK_SM = 16
H100_SMS = 132


def log(phase, msg):
    print(f"[{phase}] {msg}", flush=True)


def launch_counts():
    """{kernel: launches} of every kernel wrapper of the port."""
    from repro_torch.kernels import fused_sinr as fk
    from repro_torch.kernels import pairwise_dist as pdk
    from repro_torch.kernels import reprice_cells as rck
    return {"fused_sinr": fk.fused_sinr_accumulate.launches,
            "pairwise_dist": pdk.pairwise_dist.launches,
            "reprice_cells": rck.reprice_cells.launches}


def zero_counts():
    from repro_torch.kernels import fused_sinr as fk
    from repro_torch.kernels import pairwise_dist as pdk
    from repro_torch.kernels import reprice_cells as rck
    fk.fused_sinr_accumulate.launches = 0
    pdk.pairwise_dist.launches = 0
    rck.reprice_cells.launches = 0


def cuda_ms(fn, reps=20, warm=3):
    """Mean device time of ``fn`` in ms over ``reps`` warm calls.  The calls
    queue behind a sleep kernel long enough for the host to enqueue them
    all, so they run back to back and the host's launch cost, which exceeds
    a short kernel's time, does not set the pace."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    one = time.perf_counter() - t0
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda._sleep(int(2e9 * (3 * reps * one + 1e-3)))   # ~cycles
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound_ms(ops, nbytes):
    """The least time of a call that does ``ops`` float32 operations on
    inputs and outputs of ``nbytes``, as a kernel's ``work`` counts them:
    the larger of the bytes over the memory rate and the operations over
    the fp32 rate (``repro_torch.analysis.roofline``)."""
    from repro_torch.analysis import roofline
    t_bytes = nbytes / roofline.HBM_BW * 1e3
    t_ops = ops / roofline.PEAK_FLOPS * 1e3
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
        for line in ptxas_summary(info.log):
            log("build", "  " + line)


def ptxas_summary(text):
    """One line per compiled kernel from ``ptxas -v``: registers, spills,
    shared memory (template arguments of ``fused_sinr_kernel`` shown as
    <family, KMAX, G>)."""
    out, entry, spill = [], "?", ""
    for line in text.splitlines():
        if "Compiling entry" in line:
            entry = line.split("'")[1] if "'" in line else line.strip()
            t = re.search(r"fused_sinr_kernelILi(\d+)ELi(\d+)ELi(\d+)E",
                          entry)
            if t:
                entry = "fused_sinr_kernel<{},{},{}>".format(*t.groups())
            t = re.search(r"reprice_cells_kernelILi(\d+)E", entry)
            if t:
                entry = "reprice_cells_kernel<{}>".format(*t.groups())
        elif "spill" in line:
            spill = line.strip()
        elif "registers" in line:
            used = line.split(":", 1)[-1].strip()
            out.append(f"{entry}: {used}; {spill}")
    return out


def make_inputs(n, m, k, fading, seed, n_sectors=1, h_bs=25.0,
                extent=2000.0):
    g = torch.Generator(device="cuda").manual_seed(seed)
    u = lambda *s: torch.rand(s, generator=g, device="cuda")
    U = torch.cat([u(n, 2) * extent, 1.0 + 1.5 * u(n, 1)], dim=1)
    n_sites = max(1, -(-m // n_sectors))       # ceil: M need not divide
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
    meas = radio.rsrp(g, P).sum(dim=2)
    if meas.shape[1] < 2:
        return torch.zeros(meas.shape[0], dtype=torch.bool, device="cuda")
    top2 = torch.topk(meas, 2, dim=1).values
    return (top2[:, 0] - top2[:, 1]) < TIE_RTOL * top2[:, 0]


def check_kernel(args, model, n_sectors, attach_on_mean, idx=None,
                 group=None):
    """The kernel against its plain version; returns (max abs err of total,
    max rel err, near ties)."""
    from repro_torch.kernels import fused_sinr as fk
    U, C, P, bore, fad = args
    kw = dict(pathgain_fn=model, n_sectors=n_sectors,
              attach_on_mean=attach_on_mean, idx=idx)
    total, bval, bidx, wbest = fk._launch(U, C, P, bore, fad, group=group,
                                          **kw)
    torch.cuda.synchronize()
    t_p, v_p, i_p, w_p = fk.fused_sinr_accumulate_plain(U, C, P, bore, fad,
                                                        **kw)
    if idx is not None:
        rows = idx.long()
        U, fad = U[rows], None if fad is None else fad[rows]
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
    n_cases += ragged_cases()
    log("kernel", f"{n_cases} ragged cases agree with the plain version")
    return full_width_rows()


def ragged_cases():
    """Exact ties across lanes, then M around a lane group and past one
    shared tile, N below a block's rows, at every lane-group size."""
    from repro_torch.kernels import fused_sinr as fk
    from repro_torch.sim import pathloss
    uma, n_cases = pathloss.UMa_pathloss(), 0
    # every cell at j, j + 1 (neighbouring lanes) and j + 40: exact ties
    U, C, P, _, _ = make_inputs(2000, 20, 1, None, seed=11)
    C = torch.cat([torch.repeat_interleave(C, 2, dim=0)] * 2).contiguous()
    P = torch.cat([torch.repeat_interleave(P, 2, dim=0)] * 2).contiguous()
    bore = torch.zeros(80, device="cuda")
    fad = torch.empty(2000, 80, device="cuda").exponential_()
    for group in fk.GROUP_SIZES:
        for f, aom in ((None, False), (fad, True)):
            got = fk._launch(U, C, P, bore, f, group=group, pathgain_fn=uma,
                             attach_on_mean=aom)
            want = fk.fused_sinr_accumulate_plain(U, C, P, bore, f,
                                                  pathgain_fn=uma,
                                                  attach_on_mean=aom)
            a = got[2][:, 0]
            w_err = float(((got[3] - want[3]).abs() / want[3]).max())
            if not (torch.equal(a, want[2][:, 0]) and bool((a % 2 == 0).all())
                    and bool((a < 40).all()) and w_err <= RTOL):
                raise AssertionError(f"exact ties: the lowest index did not "
                                     f"win at G={group}")
            n_cases += 1
    log("kernel", f"exact ties across lanes (80 cells, each 4x): lowest "
        f"index at G={fk.GROUP_SIZES}, with and without attach_on_mean")
    worst = 0.0
    for m in (1, 7, 31, 32, 33, 129, 300, 600):
        for n in (1, 33, 1000):
            for group in fk.GROUP_SIZES:
                args = make_inputs(n, m, 3, "rb", seed=n + m, n_sectors=3)
                _, rel, _ = check_kernel(args, uma, 3, False, group=group)
                worst = max(worst, rel)
                n_cases += 1
    log("kernel", f"ragged M in (1, 7, 31, 32, 33, 129, 300, 600) x N in "
        f"(1, 33, 1000) x G in {fk.GROUP_SIZES}, sectored, per-RB K=3: "
        f"agree; max rel err {worst:.2e}")
    # a first tile of one cell height, a second of mixed heights: the
    # kernel's shared and per-link height terms in one launch
    for name, kw in (("UMa", {}), ("UMi", {}), ("RMa", dict(fc_GHz=0.7))):
        U, C, P, bore, fad = make_inputs(1000, 400, 2, "rb", seed=13,
                                         h_bs=30.0)
        C[256:, 2] = 10.0 + 25.0 * torch.rand(144, device="cuda")
        _, rel, _ = check_kernel((U, C, P, bore, fad),
                                 pathloss.make_pathloss(name, **kw), 1, False)
        n_cases += 1
    log("kernel", f"cells of mixed heights (UMa, UMi, RMa; M=400): agree; "
        f"last rel err {rel:.2e}")
    return n_cases


def host_ms(fn, reps=50):
    """Host time of one call of ``fn`` in ms: the enqueue, not synchronised."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    t = (time.perf_counter() - t0) / reps * 1e3
    torch.cuda.synchronize()
    return t


def gain64(U, C, bore, model, n_sectors):
    """The plain version's per-link gain (R, M) evaluated in float64."""
    U, C, bore = U.double(), C.double(), bore.double()
    dx = U[:, None, 0] - C[None, :, 0]
    dy = U[:, None, 1] - C[None, :, 1]
    dz = U[:, None, 2] - C[None, :, 2]
    d2d = torch.sqrt(dx * dx + dy * dy)
    d3d = torch.sqrt(d2d * d2d + dz * dz)
    g = model(d2d, d3d, C[:, 2][None, :], U[:, 2][:, None])
    if n_sectors > 1:
        off = torch.atan2(dy, dx) - bore[None, :]
        off = torch.atan2(torch.sin(off), torch.cos(off))
        att = torch.clamp(12.0 * (off / 1.1344640137963142) ** 2, max=30.0)
        g = g * torch.pow(10.0, -0.1 * att)
    return g


def gain_rel_err(U, C, bore, model, n_sectors, idx=None):
    """Max relative error of the per-link gain over every link: (kernel vs
    plain version, kernel vs float64, plain version vs float64).  One launch
    per cell at unit power, so that total = gain."""
    from repro_torch.kernels import fused_sinr as fk
    one = torch.ones((1, 1), device="cuda")
    kw = dict(idx=idx, pathgain_fn=model, n_sectors=n_sectors)
    got, want = [], []
    for j in range(C.shape[0]):
        c, b = C[j:j + 1].contiguous(), bore[j:j + 1].contiguous()
        got.append(fk.fused_sinr_accumulate(U, c, one, b, **kw)[0])
        want.append(fk.fused_sinr_accumulate_plain(U, c, one, b, **kw)[0])
    got, want = torch.cat(got, dim=1), torch.cat(want, dim=1)
    exact = gain64(U if idx is None else U[idx.long()], C, bore, model,
                   n_sectors)
    rel = lambda a, b: float(((a.double() - b).abs() / b.abs()).max())
    return rel(got, want.double()), rel(got, exact), rel(want, exact)


def sm_clock_mhz(fn):
    """The SM clock nvidia-smi reports while ``fn`` runs back to back."""
    seen = {}

    def sample():
        time.sleep(0.5)
        seen["out"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=clocks.sm",
             "--format=csv,noheader,nounits"], capture_output=True, text=True,
            timeout=60).stdout
    th = threading.Thread(target=sample)
    th.start()
    while th.is_alive():
        fn()
    th.join()
    torch.cuda.synchronize()
    return float(seen["out"].split()[0])


def full_width_rows():
    """The kernel at the main path's widths: its time at the wrapper's lane
    group and at every other, the plain version's, the bound, the error of
    the outputs and of the per-link gain, and the special-function pipe."""
    from repro_torch.kernels import fused_sinr as fk
    from repro_torch.sim import pathloss
    uma = pathloss.UMa_pathloss()
    cases = (  # label, rows, cells, K, fading, sectors, field rows
        ("main", 100_000, 127, 1, None, 1, None),
        ("rb4", 100_000, 127, 4, "rb", 1, None),
        ("sect3", 100_000, 126, 1, None, 3, None),
        ("small", 10_000, 127, 1, None, 1, None),
        ("idx_rb4", 100_000, 127, 4, "rb", 1, 1_000_000))
    rows = {}
    for label, n, m, k, fading, n_sectors, field in cases:
        args = make_inputs(field or n, m, k, fading, seed=7, extent=8000.0,
                           n_sectors=n_sectors)
        U, C, P, bore, fad = args
        idx = None
        if field:            # dirty rows of a larger field, with repeats
            g = torch.Generator(device="cuda").manual_seed(5)
            idx = torch.randint(0, field, (n,), generator=g, device="cuda",
                                dtype=torch.int32)
            idx[n - n // 10:] = idx[:n // 10].clone()
        kw = dict(pathgain_fn=uma, n_sectors=n_sectors, idx=idx)
        group = fk.GROUP
        abs_err, rel, ties = check_kernel(args, uma, n_sectors, False,
                                          idx=idx)
        g_err, g_k64, g_p64 = gain_rel_err(U, C, bore, uma, n_sectors,
                                           idx=idx)
        by_group = {}
        for gs in fk.GROUP_SIZES:
            if gs != group:
                check_kernel(args, uma, n_sectors, False, idx=idx, group=gs)
            by_group[gs] = cuda_ms(lambda: fk._launch(
                U, C, P, bore, fad, group=gs, **kw))
        ms = by_group[group]
        plain = cuda_ms(lambda: fk.fused_sinr_accumulate_plain(
            U, C, P, bore, fad, **kw), reps=5, warm=1)
        host = host_ms(lambda: fk.fused_sinr_accumulate(U, C, P, bore, fad,
                                                        **kw))
        fad_floats = 0 if fad is None else n * fad[0].numel()
        b_ms, b_by = bound_ms(*fk.work(
            n, m, k, fad_floats, uma.kernel_spec()[0], n_sectors,
            idx_bytes=0 if idx is None else 4 * n))
        rows[label] = dict(ms=ms, plain_ms=plain, bound_ms=b_ms,
                           bound_by=b_by, max_abs_err=abs_err)
        log("kernel", f"{label}: N={n} M={m} K={k} fading={fading} sectors="
            f"{n_sectors}{'' if idx is None else f' rows of {field} by index'}"
            f": kernel {ms:.4f} ms (G={group}), plain {plain:.4f} ms, bound "
            f"{b_ms:.4f} ms ({b_by}, {100 * b_ms / ms:.1f} % of it); max abs "
            f"err {abs_err:.3e} W, max rel err {rel:.2e}, near ties {ties}; "
            f"host {host:.4f} ms per call")
        log("kernel", f"{label}: per-link gain max rel err over {n * m} "
            f"links: kernel vs plain {g_err:.2e}; against float64, kernel "
            f"{g_k64:.2e}, plain {g_p64:.2e}")
        n64, band, plain_band, plain_off = attach_vs_float64(args, uma,
                                                             n_sectors, idx)
        log("kernel", f"{label}: attachment vs the float64 argmax: kernel "
            f"exact on all {n - n64} rows off float64 near ties ({n64} "
            f"rows closer than {TIE_RTOL:g}); {band} rows with a gap in "
            f"[{TIE_RTOL:g}, {3 * TIE_RTOL:g}), on which the plain version "
            f"differs from float64 on {plain_band} (on {plain_off} rows off "
            f"near ties in all)")
        log("kernel", f"{label}: by lane group " + ", ".join(
            f"G={gs} {t:.4f} ms" for gs, t in by_group.items()))
        if idx is not None:
            gathered = cuda_ms(lambda: fk.fused_sinr_accumulate(
                U[idx.long()], C, P, bore, fad[idx.long()],
                pathgain_fn=uma, n_sectors=n_sectors))
            log("kernel", f"{label}: reading {n} rows by index {ms:.4f} ms "
                f"vs gather U[idx], fad[idx] then the kernel {gathered:.4f} "
                f"ms ({4 * n * m * k / 1e6:.1f} MB of fading gathered)")
        if fading is None:
            mhz = sm_clock_mhz(lambda: fk.fused_sinr_accumulate(
                U, C, P, bore, fad, **kw))
            n_sfu = 3 + (1 if n_sectors > 1 else 0)
            sfu_ms = (n * m * n_sfu / (SFU_PER_CLOCK_SM * H100_SMS
                                      * mhz * 1e6) * 1e3)
            log("kernel", f"{label}: the function needs {n_sfu} "
                f"transcendental calls per link (log2 d3d^2, log2(d_bp^2 + "
                f"dh^2), exp2{', atan2' if n_sectors > 1 else ''}): "
                f"{sfu_ms:.4f} ms at 16/clock/SM x {H100_SMS} SMs x "
                f"{mhz:.0f} MHz (nvidia-smi clocks.sm during the run), "
                f"against the fp32 bound {b_ms:.4f} ms: the "
                f"{'special-function' if sfu_ms > b_ms else 'fp32'} pipe "
                f"limits; kernel {ms:.4f} ms")
        del args, U, C, P, bore, fad, idx
        torch.cuda.empty_cache()
    group_sweep(uma)
    return rows


def attach_vs_float64(args, model, n_sectors, idx):
    """The kernel's attachment against the argmax of the measurement
    evaluated in float64.  Raises unless the kernel agrees on every row
    whose two best cells differ by TIE_RTOL or more in float64; returns
    (float64 near ties, rows with a gap in [TIE_RTOL, 3 TIE_RTOL), of those
    the rows where the plain version differs from float64, rows where it
    does off near ties)."""
    from repro_torch.kernels import fused_sinr as fk
    U, C, P, bore, fad = args
    kw = dict(idx=idx, pathgain_fn=model, n_sectors=n_sectors)
    got = fk.fused_sinr_accumulate(U, C, P, bore, fad, **kw)[2][:, 0].long()
    plain = fk.fused_sinr_accumulate_plain(U, C, P, bore, fad,
                                           **kw)[2][:, 0].long()
    if idx is not None:
        U, fad = U[idx.long()], None if fad is None else fad[idx.long()]
    g = gain64(U, C, bore, model, n_sectors)[:, :, None]
    if fad is not None:
        g = g * (fad.double()[:, :, None] if fad.dim() == 2 else fad.double())
    meas = (g * P.double()[None]).sum(dim=2)
    del g
    top2 = torch.topk(meas, 2, dim=1)
    gap = (top2.values[:, 0] - top2.values[:, 1]) / top2.values[:, 0]
    best = top2.indices[:, 0]
    off = gap >= TIE_RTOL
    bad = int((got != best)[off].sum())
    if bad:
        raise AssertionError(f"kernel attachment differs from the float64 "
                             f"argmax on {bad} rows off near ties")
    band = off & (gap < 3 * TIE_RTOL)
    return (int((~off).sum()), int(band.sum()),
            int((plain != best)[band].sum()), int((plain != best)[off].sum()))


def group_sweep(model):
    """The kernel's time at every lane group G at cell counts past the
    full-width rows' (M = 300, 600), at 100 000 and 10 000 rows, unfaded and
    per-RB: the shapes behind the wrapper's ``fused_sinr.GROUP``."""
    from repro_torch.kernels import fused_sinr as fk
    for n, m, k, fading in ((100_000, 300, 1, None), (100_000, 600, 1, None),
                            (10_000, 300, 1, None), (10_000, 600, 1, None),
                            (100_000, 300, 4, "rb"), (100_000, 600, 4, "rb")):
        U, C, P, bore, fad = make_inputs(n, m, k, fading, seed=7,
                                         extent=8000.0)
        t = {gs: cuda_ms(lambda: fk._launch(U, C, P, bore, fad, group=gs,
                                            pathgain_fn=model))
             for gs in fk.GROUP_SIZES}
        log("kernel", f"lane groups at N={n} M={m} K={k} fading={fading}: "
            + ", ".join(f"G={gs} {x:.4f} ms" for gs, x in t.items())
            + f"; the wrapper takes G={fk.GROUP}")
        del U, C, P, bore, fad
        torch.cuda.empty_cache()


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
    bound, by = bound_ms(*pdk.work(n, m))
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


def per_tti_ms(fns, static, state, draws, reps=3):
    """Host-clock ms per TTI: (rollout of 6 TTIs - rollout of 1) / 5, the
    median of ``reps`` pairs after one warm-up rollout (a first rollout
    pays the allocator's growth, which a single pair can charge to the
    1-TTI side and so report a negative time)."""
    fns.rollout(static, state, 1, draws)
    per = []
    for _ in range(reps):
        times = {}
        for n in (1, 6):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fns.rollout(static, state, n, draws)
            torch.cuda.synchronize()
            times[n] = time.perf_counter() - t0
        per.append((times[6] - times[1]) / 5 * 1e3)
    return sorted(per)[len(per) // 2]


def profiled(fn):
    """(wall seconds, {kernel: (device us, launches)}) of one ``fn()`` under
    the package's trace (``repro_torch.obs.profile.trace``), synchronised
    at both ends."""
    import tempfile
    from repro_torch.obs import profile
    with tempfile.TemporaryDirectory(prefix="trace-") as d:
        with profile.trace(d) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    return wall, profile.kernel_times(prof)


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


def device_breakdown(fns, static, state, draws, phase="episode"):
    """Per-TTI device busy time, kernel launches and the heaviest kernels:
    a rollout of 6 TTIs minus a rollout of 1, which cancels the set-up (the
    full-width RadioState init)."""
    w1, k1 = profiled(lambda: fns.rollout(static, state, 1, draws))
    w6, k6 = profiled(lambda: fns.rollout(static, state, 6, draws))
    per = {name: ((us - k1.get(name, (0.0, 0))[0]) / 5,
                  (cnt - k1.get(name, (0.0, 0))[1]) / 5)
           for name, (us, cnt) in k6.items()}
    log_breakdown(phase, "TTI", (w6 - w1) / 5 * 1e6, per)


def phase_episode():
    from repro_torch.core.crrm import CRRM
    from repro_torch.core.params import CRRM_parameters
    from repro_torch.kernels import fused_sinr as fk
    from repro_torch.mac.engine import Draws
    kw = EPISODE
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
    return launches, ms


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



def tput_off(p, r):
    """Where the throughputs ``p`` are off from ``r`` by more than RTOL of
    ``r`` (plus 1e-3 bit/s), as in crrm_bench's ``tput_off_share``."""
    p, r = p.double(), r.double()
    return (p - r).abs() > RTOL * r.abs() + 1e-3


def tput_off_share(p, r):
    return float(tput_off(p, r).double().mean())


def compare_modes(label, phase, n_tti, share_limit=None, **fns_kw):
    """Dense (torch) against incremental at 100 000 UEs on the same draws:
    max relative throughput error and the share of throughputs off, ms/TTI
    of each, and the final states.  The max error is held to RTOL, or with
    ``share_limit`` the share off to it."""
    from repro_torch.core.crrm import CRRM
    from repro_torch.core.params import CRRM_parameters
    from repro_torch.mac.engine import Draws, seed_churn_state
    outs, times, finals = {}, {}, {}
    be_inc = fns_kw.pop("inc_backend")
    for mode, be in (("dense", "torch"), ("incremental", be_inc)):
        sim = CRRM(CRRM_parameters(n_ues=100_000, radio_mode=mode,
                                   **EPISODE))
        fns = sim.episode_fns(inc_backend=be, **fns_kw)
        static, state = sim.episode_static(), sim.init_episode_state()
        if "churn" in fns_kw:
            state = seed_churn_state(state, static, sim.params)
        finals[mode], outs[mode] = fns.rollout(static, state, n_tti,
                                               Draws(3, "cuda"))
        times[mode] = per_tti_ms(fns, static, state, Draws(3, "cuda"))
        del sim, fns, static, state
    dense, inc = outs["dense"], outs["incremental"]
    rel = float((inc - dense).abs().max() / dense.abs().max().clamp(min=1.0))
    off = tput_off(inc, dense)
    share = float(off.double().mean())
    log(phase, f"100000 x 127 {label}: dense (torch) {times['dense']:.3f} "
        f"ms/TTI, incremental ({be_inc}) {times['incremental']:.3f} ms/TTI, "
        f"max rel err {rel:.3e}, throughput share off {share:.3e} over "
        f"{n_tti} TTIs (UEs off per TTI {off.sum(dim=1).tolist()})")
    if (rel > RTOL) if share_limit is None else (share > share_limit):
        raise AssertionError(f"{label}: incremental ({be_inc}) deviates "
                             f"from dense: max rel err {rel:.3e}, share off "
                             f"{share:.3e}")
    return finals


def reprice_flips(n_ues, n_tti, faults, seed=3):
    """CQI steps that ``"auto"``'s re-pricing (``reprice_cells``) flips
    against the torch re-pricing, per re-pricing of an incremental storm
    rollout on ``Draws(seed)``: each ``"auto"`` call of
    ``radio.radio_update_cells`` is repeated on ``"torch"`` and compared."""
    from repro_torch.core.crrm import CRRM
    from repro_torch.core.params import CRRM_parameters
    from repro_torch.mac.engine import Draws
    from repro_torch.sim import radio
    update, flips = radio.radio_update_cells, []

    def counted(cfg, state, P, mask, **kw):
        new = update(cfg, state, P, mask, **kw)
        ref = update(cfg, state, P, mask, **{**kw, "backend": "torch"})
        flips.append(int((new.cqi != ref.cqi).sum()))
        return new
    sim = CRRM(CRRM_parameters(n_ues=n_ues, radio_mode="incremental",
                               **EPISODE))
    radio.radio_update_cells = counted
    try:
        sim.episode_fns(inc_backend="auto", faults=faults).rollout(
            sim.episode_static(), sim.init_episode_state(), n_tti,
            Draws(seed, "cuda"))
    finally:
        radio.radio_update_cells = update
    return flips


def phase_churn():
    """The million-UE episode under birth-death churn: newborn rows join
    the mover rows in the fused kernel's index, one launch per TTI."""
    from repro_torch.core.crrm import CRRM
    from repro_torch.core.params import CRRM_parameters
    from repro_torch.mac.engine import Draws, seed_churn_state
    from repro_torch.sim.mobility import ChurnConfig
    churn, n_tti = ChurnConfig(**CHURN_1M), 20
    torch.cuda.reset_peak_memory_stats()
    sim = CRRM(CRRM_parameters(n_ues=1_000_000, radio_mode="incremental",
                               **EPISODE))
    fns = sim.episode_fns(inc_backend="fused", churn=churn, telemetry=True)
    static = sim.episode_static()
    state = seed_churn_state(sim.init_episode_state(), static, sim.params)
    draws = Draws(3, "cuda")
    # -- the churn path: counts to 0 just before, read just after ---------
    torch.cuda.synchronize()
    zero_counts()
    out, tput, telem = fns.rollout(static, state, n_tti, draws)
    torch.cuda.synchronize()
    counts = launch_counts()
    per_tti = counts["fused_sinr"] / n_tti
    active = telem.active_ues.tolist()
    log("churn", f"1M x 127 incremental fused under {CHURN_1M}: launches "
        f"{counts} over {n_tti} TTIs ({per_tti:g} fused_sinr per TTI)")
    log("churn", f"active_ues per TTI: {active}")
    log("churn", f"dirty rows per TTI (movers + newborns): "
        f"{telem.dirty_rows.tolist()}")
    if per_tti != 1:
        raise AssertionError(f"expected 1 fused_sinr launch per TTI, got "
                             f"{per_tti}")
    if not (tput.shape == (n_tti, 1_000_000) and torch.isfinite(tput).all()
            and int(telem.active_ues[-1]) == int(out.active.sum())
            and bool((tput[-1][~out.active] == 0.0).all())
            and min(active) < 1_000_000 and torch.isfinite(out.U).all()):
        raise AssertionError("churn: bad throughput, counts or positions")
    plain = sim.episode_fns(inc_backend="fused", churn=churn)
    ms_churn = per_tti_ms(plain, static, state, draws)
    ms_still = per_tti_ms(sim.episode_fns(inc_backend="fused"), static,
                          sim.init_episode_state(), draws)
    peak = torch.cuda.max_memory_allocated() / 2**30
    log("churn", f"1M x 127: {ms_churn:.3f} ms/TTI with churn, "
        f"{ms_still:.3f} ms/TTI without (host clock, synchronised); peak "
        f"device memory {peak:.2f} GiB")
    device_breakdown(plain, static, state, draws, phase="churn")
    del sim, fns, plain, static, state, out, tput, telem
    torch.cuda.empty_cache()
    finals = compare_modes(f"under churn {CHURN_100K}", "churn", 10,
                           inc_backend="fused",
                           churn=ChurnConfig(**CHURN_100K))
    if not torch.equal(finals["dense"].active, finals["incremental"].active):
        raise AssertionError("churn: dense and incremental active masks "
                             "differ")
    return per_tti


def phase_faults():
    """The million-UE episode under outage_storm's fault process: the
    incremental rows take the torch route (the kernel never holds the
    carried gains), and fault transitions re-derive every UE branch-free."""
    from repro_torch.core.crrm import CRRM
    from repro_torch.core.params import CRRM_parameters
    from repro_torch.env import CrrmEnv
    from repro_torch.mac.engine import Draws
    from repro_torch.obs import format_summary, summarize
    from repro_torch.sim import faults as sim_faults
    faults, n_tti = sim_faults.FaultConfig(**STORM), 20
    torch.cuda.reset_peak_memory_stats()
    sim = CRRM(CRRM_parameters(n_ues=1_000_000, radio_mode="incremental",
                               **EPISODE))
    fns = sim.episode_fns(inc_backend="auto", faults=faults, telemetry=True)
    log("faults", f"inc_backend='auto' under faults resolves to "
        f"{fns.inc_backend!r}: {fns.inc_reason}")
    if fns.inc_backend != "torch":
        raise AssertionError("auto did not resolve to the torch rows")
    try:
        sim.episode_fns(inc_backend="fused", faults=faults)
    except ValueError as e:
        log("faults", f"inc_backend='fused' under faults raises ValueError: "
            f"{e}")
    else:
        raise AssertionError("inc_backend='fused' under faults did not raise")
    static, state, draws = sim.episode_static(), sim.init_episode_state(), \
        Draws(3, "cuda")
    torch.cuda.synchronize()
    zero_counts()
    out, tput, telem = fns.rollout(static, state, n_tti, draws)
    torch.cuda.synchronize()
    counts = launch_counts()
    log("faults", f"1M x 127 incremental under {STORM}: launches {counts} "
        f"over {n_tti} TTIs")
    log("faults", f"cells_down per TTI: {telem.cells_down.tolist()}")
    log("faults", f"reattach_events per TTI: "
        f"{telem.reattach_events.tolist()}")
    if not (tput.shape == (n_tti, 1_000_000) and torch.isfinite(tput).all()
            and out.cell_state.shape == (127,)):
        raise AssertionError("faults: bad throughput or fault state")
    plain = sim.episode_fns(inc_backend="auto", faults=faults)
    ms_faults = per_tti_ms(plain, static, state, draws)
    ms_off = per_tti_ms(sim.episode_fns(inc_backend="torch", faults=0),
                        static, state, draws)
    peak = torch.cuda.max_memory_allocated() / 2**30
    # how often the branch-free cell update has a transition to apply
    cs, moved = torch.zeros(127, dtype=torch.int32, device="cuda"), 0
    for t in range(1000):
        cs, changed = sim_faults.fault_step(draws.fault_uniform(t, 127), cs,
                                            1e-3, faults)
        moved += int(changed.any())
    log("faults", f"1M x 127: {ms_faults:.3f} ms/TTI with faults (torch "
        f"rows, with_gain), {ms_off:.3f} ms/TTI without (torch rows); peak "
        f"device memory {peak:.2f} GiB; a cell changes state in {moved} of "
        f"1000 TTIs")
    device_breakdown(plain, static, state, draws, phase="faults")
    del sim, fns, plain, static, state, out, tput, telem
    torch.cuda.empty_cache()
    # the torch route re-prices with the dense chain's own arithmetic and
    # is held to RTOL; "auto" re-prices in reprice_cells, whose cell total
    # is summed in another order, so a CQI step may flip (counted below)
    # and move its cell's pf shares: it is held to the share of throughputs
    # off
    for be, limit in (("torch", None), ("auto", TPUT_OFF_SHARE)):
        finals = compare_modes(f"under faults {STORM}", "faults", 10,
                               share_limit=limit, inc_backend=be,
                               faults=faults)
        if not torch.equal(finals["dense"].cell_state,
                           finals["incremental"].cell_state):
            raise AssertionError(f"faults: dense and incremental ({be}) "
                                 f"fault states differ")
    log("faults", f"100000 x 127: CQI steps that reprice_cells flips against "
        f"the torch re-pricing, per re-pricing of the same 10 TTIs: "
        f"{reprice_flips(100_000, 10, faults)}")
    env = CrrmEnv(scenario="outage_storm",
                  scenario_overrides={"n_ues": 100_000}, tti_per_step=5,
                  episode_tti=10, telemetry=True)
    state, _ = env.reset(0)
    done, step_ms, telems = False, [], []
    while not done:
        (state, obs, reward, done, info), ms = env_step_ms(env, state, None)
        done = bool(done)
        step_ms.append(ms)
        telems.append(info["telemetry"])
    from repro_torch.obs.telemetry import Telemetry
    stacked = Telemetry(*(None if v[0] is None else torch.cat(v)
                          for v in zip(*telems)))
    log("faults", f"CrrmEnv outage_storm at 100000 UEs x {env.n_cells} "
        f"cells: ms per env step (5 TTIs) "
        + ", ".join(f"{ms:.3f}" for ms in step_ms)
        + f"; KPIs over the episode:\n" + format_summary(
            summarize(stacked, tti_s=env.params.tti_s)))
    if not (torch.isfinite(obs.tput).all() and len(step_ms) == 2):
        raise AssertionError("faults: bad outage_storm env episode")
    del env, state, obs
    torch.cuda.empty_cache()


def storm_field_power(static, seed=5):
    """The field's power with ~13 % of the cells dark (DOWN) and ~8 %
    asleep (10 dB down), as a storm leaves it."""
    m = static.P.shape[0]
    g = torch.Generator(device="cuda").manual_seed(seed)
    order = torch.randperm(m, generator=g, device="cuda")
    mult = torch.ones(m, device="cuda")
    n_dark, n_sleep = round(0.13 * m), round(0.08 * m)
    mult[order[:n_dark]] = 0.0
    mult[order[n_dark:n_dark + n_sleep]] = 0.1
    return (static.P * mult[:, None]).contiguous(), n_dark, n_sleep


def phase_reprice(smi):
    """The fault re-pricing kernel on the million-UE field's carried gain
    against its plain version (the ragged shapes, ties and gain layouts
    are ``tests/test_torch_cuda.py``'s); launches per TTI of a storm and a
    fault-free rollout; the storm on ``"auto"`` against ``"torch"``."""
    from repro_torch.core.crrm import CRRM
    from repro_torch.core.params import CRRM_parameters
    from repro_torch.kernels import build
    from repro_torch.kernels import reprice_cells as rck
    from repro_torch.mac.engine import Draws
    from repro_torch.sim import faults as sim_faults
    from repro_torch.sim import radio
    _, info = build.load("reprice_cells")
    for line in ptxas_summary(info.log):
        log("reprice", "ptxas " + line)
    # -- the million-UE field's carried gain under a storm's power --------
    sim = CRRM(CRRM_parameters(n_ues=1_000_000, radio_mode="incremental",
                               **EPISODE))
    static, rcfg = sim.radio_static(), sim.radio_config()
    G = radio.pathgains(rcfg, sim.U._data, static.C, static.bore)
    P, n_dark, n_sleep = storm_field_power(static)
    noise_w = rcfg.noise_w
    n, m = G.shape
    zero_counts()
    a, gamma = rck.reprice_cells(G, P, noise_w)
    torch.cuda.synchronize()
    launches = launch_counts()["reprice_cells"]
    if launches != 1:
        raise AssertionError(f"reprice_cells launched {launches} times")
    a_p, gamma_p = rck.reprice_cells_plain(G, P, noise_w)
    off = int((a != a_p).sum())
    excess = rck.gamma_excess(gamma, gamma_p, m)
    rel = float(((gamma.double() - gamma_p.double()).abs()
                 / gamma_p.double().clamp_min(1e-30)).max())
    # the CQI steps that the total's other order flips in one re-pricing
    cqi_flips = int((radio.se_chain(rcfg, gamma)[1]
                     != radio.se_chain(rcfg, gamma_p)[1]).sum())
    del a_p, gamma_p
    ms = cuda_ms(lambda: rck.reprice_cells(G, P, noise_w), reps=20)
    plain_ms = cuda_ms(lambda: rck.reprice_cells_plain(G, P, noise_w),
                       reps=5)
    bound, by = bound_ms(*rck.work(n, m, 1))
    log("reprice", f"N={n} M={m} K=1 ({smi}; {n_dark} dark, {n_sleep} "
        f"sleeping cells): kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
        f"bound {bound:.4f} ms ({by}); attachments off {off}; gamma max rel "
        f"err {rel:.3e}, {excess:.3f} of its bound; CQI steps flipped "
        f"{cqi_flips} of {n}")
    if off or excess > 1.0:
        raise AssertionError(f"reprice_cells at full width: {off} "
                             f"attachments off, gamma {excess:.3f} of bound")
    del G, a, gamma, sim, static
    torch.cuda.empty_cache()
    # -- launches per TTI: a storm rollout and a fault-free one ------------
    faults, n_tti = sim_faults.FaultConfig(**STORM), 10
    sim = CRRM(CRRM_parameters(n_ues=1_000_000, radio_mode="incremental",
                               **EPISODE))
    static, state = sim.episode_static(), sim.init_episode_state()
    per, outs = {}, {}
    for label, kw in (("storm auto", dict(inc_backend="auto",
                                          faults=faults)),
                      ("storm torch", dict(inc_backend="torch",
                                           faults=faults)),
                      ("fault-free auto", dict(inc_backend="auto",
                                               faults=0))):
        fns = sim.episode_fns(**kw)
        fns.rollout(static, state, 2, Draws(7, "cuda"))     # warm
        torch.cuda.synchronize()
        zero_counts()
        t0 = time.perf_counter()
        outs[label] = fns.rollout(static, state, n_tti, Draws(7, "cuda"))
        torch.cuda.synchronize()
        ms_tti = (time.perf_counter() - t0) * 1e3 / n_tti
        per[label] = launch_counts()["reprice_cells"] / n_tti
        log("reprice", f"{label}: reprice_cells launches per TTI "
            f"{per[label]:.2f}, {ms_tti:.3f} ms/TTI over {n_tti} TTIs "
            f"(host clock, synchronised)")
    if per["storm auto"] != 1.0 or per["storm torch"] or \
            per["fault-free auto"]:
        raise AssertionError(f"reprice_cells launches per TTI {per}")
    (s_a, t_a), (s_t, t_t) = outs["storm auto"], outs["storm torch"]
    serving_off = int((s_a.serving != s_t.serving).sum())
    tput_off = tput_off_share(t_a, t_t)
    log("reprice", f"storm auto vs torch over {n_tti} TTIs: serving cells "
        f"off {serving_off}, throughput share off {tput_off:.3e}; "
        f"cell states equal {torch.equal(s_a.cell_state, s_t.cell_state)}")
    if (not torch.equal(s_a.cell_state, s_t.cell_state) or serving_off
            or tput_off > TPUT_OFF_SHARE):
        raise AssertionError(f"reprice_cells: the storm on \"auto\" parts "
                             f"from \"torch\": serving cells off "
                             f"{serving_off}, throughput share off "
                             f"{tput_off:.3e}")
    del sim, static, state, outs, s_a, s_t, t_a, t_t
    torch.cuda.empty_cache()
    return dict(launches=launches, ms=ms, plain_ms=plain_ms, bound_ms=bound,
                bound_by=by, max_rel_err=rel)


def launches_per_tti(fn, n_tti):
    """Device kernel launches per TTI of ``fn()`` under the profiler."""
    _, per = profiled(fn)
    return sum(c for _, c in per.values()) / n_tti


def phase_batch():
    """CrrmEnv's batch axis on dense_urban_twin at 100 000 UEs: B = 8 envs
    stepped to done and autoreset; each row held to its single env."""
    from repro_torch.env import CrrmEnv
    kw = dict(scenario="dense_urban_twin",
              scenario_overrides={"n_ues": 100_000}, tti_per_step=5,
              episode_tti=10)
    env = CrrmEnv(**kw)
    seeds, B = list(range(8)), 8
    acts = torch.stack([env.uniform_action()] * B)
    torch.cuda.synchronize()
    zero_counts()
    states, _ = env.reset_batch(seeds)
    done, batch_ms = torch.zeros(B, dtype=torch.bool), []
    while not bool(done.all()):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        states, obs, reward, done = env.step_batch(states, acts)
        torch.cuda.synchronize()
        batch_ms.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    s_ar, _, _, d_ar = env.step_autoreset_batch(states, acts,
                                                [s + 100 for s in seeds])
    torch.cuda.synchronize()
    ar_ms = (time.perf_counter() - t0) * 1e3
    counts = launch_counts()
    if not (obs.tput.shape == (B, 100_000) and torch.isfinite(obs.tput).all()
            and len(batch_ms) == 2 and bool(d_ar.all())
            and s_ar.t.tolist() == [0] * B
            and s_ar.seed.tolist() == [s + 100 for s in seeds]):
        raise AssertionError("batch: bad batched episode or autoreset")
    single_ms = []
    s, _ = env.reset(0)
    for _ in range(2):
        (s, *_), ms = env_step_ms(env, s, acts[0])
        single_ms.append(ms)
    log("batch", f"dense_urban_twin at 100000 UEs, B = {B}: launches "
        f"{counts}; ms per batched step (5 TTIs) "
        + ", ".join(f"{ms:.3f}" for ms in batch_ms)
        + f"; step_autoreset_batch {ar_ms:.3f}; single env step "
        + ", ".join(f"{ms:.3f}" for ms in single_ms)
        + f" (x{B}: {B * single_ms[-1]:.3f})")
    st0, _ = env.reset_batch(seeds)
    lb = launches_per_tti(lambda: env.step_batch(st0, acts), 5)
    ls = launches_per_tti(lambda: env.step(env.reset(0)[0], acts[0]), 5)
    log("batch", f"kernel launches per TTI: batched (B = {B}) {lb:.0f}, "
        f"single env {ls:.0f} (x{B}: {B * ls:.0f})")
    wall, per = profiled(lambda: env.step_batch(st0, acts))
    log_breakdown("batch", "batched step", wall * 1e6, per)
    del env, states, s_ar, st0, obs
    # -- row b == reset(seed_b) + step, in deterministic mode -------------
    torch.use_deterministic_algorithms(True)
    try:
        env = CrrmEnv(telemetry=True, **kw)
        out = env.step_batch(env.reset_batch(seeds)[0], acts)
        worst, differ = 0.0, set()
        for b, seed in enumerate(seeds):
            one = env.step(env.reset(seed)[0], acts[b])
            pairs = [(f"state.{f}", x[b], y) for f, x, y in
                     zip(one[0]._fields, out[0], one[0]) if y is not None]
            pairs += [("obs.tput", out[1].tput[b], one[1].tput),
                      ("reward", out[2][b], one[2])]
            pairs += [(f"telemetry.{f}", x[b], y) for f, x, y in
                      zip(one[4]["telemetry"]._fields, out[4]["telemetry"],
                          one[4]["telemetry"]) if y is not None]
            for name, x, y in pairs:
                if torch.equal(x, y):
                    continue
                differ.add(name)
                if not x.is_floating_point():
                    raise AssertionError(f"batch: {name} of row {b} differs")
                rel = (x - y).abs() / y.abs().clamp(min=1e-30)
                worst = max(worst, float(rel.max()))
    finally:
        torch.use_deterministic_algorithms(False)
    if not differ:
        log("batch", "deterministic mode: every row equals reset(seed_b) + "
            "step bit for bit (state, obs, reward, telemetry)")
    elif worst <= 1e-6:
        log("batch", f"deterministic mode: rows agree within rtol 1e-6 "
            f"(max rel {worst:.3e}), not bit for bit in {sorted(differ)}: "
            f"a float reduction over the UE axis of B envs at once adds in "
            f"another order than over one env's")
    else:
        raise AssertionError(f"batch: row b deviates from the single env "
                             f"in {sorted(differ)}: {worst:.3e}")
    del env, out
    env_r = CrrmEnv(resample_topology=True, **kw)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    st_r, _ = env_r.reset_batch(seeds)
    torch.cuda.synchronize()
    ms_r = (time.perf_counter() - t0) * 1e3
    if not (st_r.ep.U.shape == (B, 100_000, 3)
            and torch.isfinite(st_r.static.se).all()
            and not torch.equal(st_r.ep.U[0], st_r.ep.U[1])):
        raise AssertionError("batch: bad resampled batched reset")
    log("batch", f"resample_topology reset_batch, B = {B} x 100000 UEs: "
        f"{ms_r:.3f} ms")
    del env_r, st_r
    torch.cuda.empty_cache()


def timed_ms(fn):
    """``(fn(), host-clock ms)``, synchronised at both ends."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def twin_dir():
    """A scratch directory for checkpoints inside the checkout's build/."""
    import tempfile
    root = Path(__file__).resolve().parent / "build"
    root.mkdir(exist_ok=True)
    return tempfile.TemporaryDirectory(prefix="twin-", dir=root)


def phase_twin():
    """A watchdog-armed TwinServer over the million-UE churn episode, the
    dirty rows through fused_sinr; then the reference bench's twin arm."""
    from repro_torch.core.crrm import CRRM
    from repro_torch.core.params import CRRM_parameters
    from repro_torch.kernels import fused_sinr as fk
    from repro_torch.mac.engine import Draws
    from repro_torch.obs import telemetry as obs_telemetry
    from repro_torch.robust import chaos, guard
    from repro_torch.robust.watchdog import WatchdogConfig
    from repro_torch.sim.mobility import ChurnConfig
    from repro_torch.twin.server import TwinServer
    n_ues, chunk, n_tti = 1_000_000, 50, 150
    launches = lambda: fk.fused_sinr_accumulate.launches
    torch.cuda.reset_peak_memory_stats()
    with twin_dir() as td:
        sim = CRRM(CRRM_parameters(n_ues=n_ues, radio_mode="incremental",
                                   **EPISODE))
        wd = WatchdogConfig(max_retries=3, backoff_s=0.0,
                            ckpt_every_chunks=1)
        t0 = time.perf_counter()
        srv = TwinServer(sim, ChurnConfig(**CHURN_1M), chunk_tti=chunk,
                         ckpt_dir=td, keep_last=2, inc_backend="fused",
                         watchdog=wd)
        torch.cuda.synchronize()
        log("twin", f"{n_ues} x 127 TwinServer under {CHURN_1M}, chunks of "
            f"{chunk} TTIs, inc_backend={srv.inc_backend!r} (rows "
            f"{srv.fns.inc_backend!r}), watchdog {tuple(wd)}: set-up incl. "
            f"the t=0 checkpoint {time.perf_counter() - t0:.2f} s")
        # -- the twin path: counts to 0 just before, read just after -----
        torch.cuda.synchronize()
        zero_counts()
        per_chunk, guarded_ms = [], []
        for _ in range(3):
            before = launches()
            kpis, ms = timed_ms(srv.step_chunk)
            per_chunk.append(launches() - before)
            guarded_ms.append(ms)
        counts = launch_counts()
        log("twin", f"path: launches {counts} over {n_tti} TTIs; fused_sinr "
            f"per chunk {per_chunk}; active_ues {kpis['active_ues']:.0f} at "
            f"t={kpis['t']:.0f}")
        if per_chunk != [chunk] * 3 or counts["fused_sinr"] != n_tti:
            raise AssertionError(f"expected {chunk} fused_sinr launches per "
                                 f"chunk, got {per_chunk}")
        if not (torch.isfinite(srv.last_tput).all()
                and srv.last_tput.shape == (chunk, n_ues)
                and 0 < kpis["active_ues"] < n_ues
                and all(math.isfinite(v) for v in kpis.values())):
            raise AssertionError("twin: bad throughput or KPIs")
        # -- the serving cost, guarded and not, and its parts ------------
        srv.watchdog = None
        plain_ms = [timed_ms(srv.step_chunk)[1] for _ in range(2)]
        srv.watchdog = wd
        out, ms_chunk = timed_ms(lambda: srv._chunk(
            srv.static, srv.state, srv.power, srv.fairness))
        ok, ms_guard = timed_ms(lambda: guard.carry_ok(out[0]))
        _, ms_sum = timed_ms(lambda: obs_telemetry.summarize(
            out[2], tti_s=sim.params.tti_s))
        del out
        # the same chunk without telemetry, and a profile of one TTI
        quiet = sim.episode_fns(churn=srv.churn, inc_backend="fused")
        draws = Draws(int(srv.state.seed), sim.device)
        _, ms_quiet = timed_ms(lambda: quiet.rollout(
            srv.static, srv.state, chunk, draws, action=srv.power,
            fairness_p=srv.fairness))
        log("twin", "guarded serving ms per chunk (chunk, guard, summary, "
            "checkpoint) " + ", ".join(f"{ms:.3f}" for ms in guarded_ms)
            + f" = {guarded_ms[-1] / chunk:.3f} ms/TTI; without the guarded "
            "loop (chunk, summary) " + ", ".join(f"{ms:.3f}"
                                                 for ms in plain_ms)
            + f" = {plain_ms[-1] / chunk:.3f} ms/TTI")
        log("twin", f"parts of one chunk: rollout {ms_chunk:.3f} ms "
            f"({ms_chunk / chunk:.3f} ms/TTI; without telemetry "
            f"{ms_quiet / chunk:.3f} ms/TTI), guard {ms_guard:.3f} ms "
            f"(carry_ok={ok}), summary {ms_sum:.3f} ms")
        device_breakdown(types.SimpleNamespace(
            rollout=lambda st, s, n, d: srv.fns.rollout(
                st, s, n, d, action=srv.power, fairness_p=srv.fairness)),
            srv.static, srv.state, draws, phase="twin")
        del quiet
        # -- checkpoint costs at 1M ---------------------------------------
        step, ms_save = timed_ms(srv.checkpoint)
        th, ms_block = timed_ms(lambda: srv.checkpoint(block=False))
        t0 = time.perf_counter()
        th.join()
        s_write = time.perf_counter() - t0
        restored, ms_restore = timed_ms(srv.restore)
        nbytes = sum(x.numel() * x.element_size()
                     for x in srv.state if x is not None)
        peak = torch.cuda.max_memory_allocated() / 2**30
        log("twin", f"checkpoint of {nbytes / 2**30:.3f} GiB of state at "
            f"t={step}: sync save {ms_save / 1e3:.3f} s; save_async blocks "
            f"the caller {ms_block / 1e3:.3f} s, its writer ends "
            f"{s_write:.3f} s later; restore {ms_restore / 1e3:.3f} s; peak "
            f"device memory {peak:.2f} GiB")
        # -- kill and restore, bit for bit in deterministic mode ----------
        srv.watchdog = None
        torch.use_deterministic_algorithms(True)
        try:
            srv.checkpoint()
            ref = [srv.step_chunk() for _ in range(2)]
            tput, final = srv.last_tput, srv.state
            t_new = srv.restore()
            again = [srv.step_chunk() for _ in range(2)]
        finally:
            torch.use_deterministic_algorithms(False)
        if not (leaves_equal(final, srv.state) and again == ref
                and torch.equal(tput, srv.last_tput)):
            raise AssertionError("twin: restore-resume is not bitwise in "
                                 "deterministic mode")
        log("twin", f"deterministic mode: restored t={t_new}, re-served 2 "
            f"chunks: every leaf, the throughput and the KPI dicts equal "
            f"the uninterrupted run bit for bit")
        # -- injected faults under the watchdog, on the route it began on -
        srv.watchdog = wd
        srv.checkpoint()                 # the rollback target
        fns = srv.fns
        t_before, before = srv.t, launches()
        chaos._poison(srv)
        _, ms_nan = timed_ms(srv.step_chunk)
        nan_launches = launches() - before
        real, boom = srv._chunk, {"armed": True}

        def explode_once(*a):
            if boom["armed"]:
                boom["armed"] = False
                raise RuntimeError("injected kernel failure")
            return real(*a)

        srv._chunk = explode_once
        before = launches()
        _, ms_crash = timed_ms(srv.step_chunk)
        crash_launches = launches() - before
        srv._chunk = real
        if not (srv.t == t_before + 2 * chunk and srv.inc_backend == "fused"
                and srv.fns is fns and crash_launches == chunk
                and nan_launches == 2 * chunk
                and any("GuardViolation" in h for h in srv.fault_history)
                and any("injected kernel failure" in h
                        for h in srv.fault_history)
                and not any("degrad" in h for h in srv.fault_history)):
            raise AssertionError(f"twin: bad recovery: {srv.fault_history}")
        log("twin", f"recovered on inc_backend={srv.inc_backend!r}: injected "
            f"NaN {ms_nan / 1e3:.3f} s ({nan_launches} fused_sinr launches: "
            f"the poisoned chunk and its retry), raised chunk "
            f"{ms_crash / 1e3:.3f} s ({crash_launches} launches)")
        # -- a timed-out chunk abandoned on its thread --------------------
        timeout_s = max(1.0, 3 * guarded_ms[-1] / 1e3)
        srv.watchdog = wd._replace(chunk_timeout_s=timeout_s)
        armed = {"on": True}

        def slow(*a):
            # launch near the deadline, then hang on to the result: the
            # recovery runs beside the abandoned worker's launches and state
            if not armed["on"]:
                return real(*a)
            armed["on"] = False
            time.sleep(0.9 * timeout_s)
            out = real(*a)
            time.sleep(timeout_s)
            return out

        srv._chunk = slow
        torch.cuda.reset_peak_memory_stats()
        t_before = srv.t
        _, ms_timeout = timed_ms(srv.step_chunk)
        for th in threading.enumerate():        # the abandoned worker
            if "_worker" in th.name:
                th.join(60)
        torch.cuda.synchronize()
        peak_to = torch.cuda.max_memory_allocated() / 2**30
        srv._chunk, srv.watchdog = real, wd
        srv.step_chunk()
        if not (srv.t == t_before + 2 * chunk
                and any("ChunkTimeout" in h for h in srv.fault_history)):
            raise AssertionError("twin: the timed-out chunk was not fenced")
        log("twin", f"timed-out chunk ({timeout_s:.2f} s limit) recovered in "
            f"{ms_timeout / 1e3:.3f} s; peak device memory while the "
            f"abandoned worker ran {peak_to:.2f} GiB; t={srv.t} after one "
            f"more chunk")
        for line in srv.fault_history:
            log("twin", f"history: {line}")
        del srv, sim, final, tput, restored
    torch.cuda.empty_cache()
    twin_faded()
    twin_arm()


def twin_faded():
    """The checkpoint at its largest: the same twin with Rayleigh fading,
    whose 1M x 127 fading factor the state carries under churn."""
    from repro_torch.core.crrm import CRRM
    from repro_torch.core.params import CRRM_parameters
    from repro_torch.sim.mobility import ChurnConfig
    from repro_torch.twin.server import TwinServer
    torch.cuda.reset_peak_memory_stats()
    with twin_dir() as td:
        srv = TwinServer(CRRM(CRRM_parameters(
            n_ues=1_000_000, radio_mode="incremental", rayleigh_fading=True,
            **EPISODE)), ChurnConfig(**CHURN_1M), chunk_tti=50,
            ckpt_dir=td, keep_last=2, inc_backend="fused")
        srv.step_chunk()
        kpis, ms = timed_ms(srv.step_chunk)
        _, ms_save = timed_ms(srv.checkpoint)
        th, ms_block = timed_ms(lambda: srv.checkpoint(block=False))
        t0 = time.perf_counter()
        th.join()
        s_write = time.perf_counter() - t0
        _, ms_restore = timed_ms(srv.restore)
        nbytes = sum(x.numel() * x.element_size()
                     for x in srv.state if x is not None)
        peak = torch.cuda.max_memory_allocated() / 2**30
        if not (srv.state.fad is not None and math.isfinite(
                kpis["served_mbits"])):
            raise AssertionError("twin: the faded state carries no fading")
        log("twin", f"with Rayleigh fading (fad {tuple(srv.state.fad.shape)}"
            f" carried): {ms / 50:.3f} ms/TTI unguarded; checkpoint of "
            f"{nbytes / 2**30:.3f} GiB: sync save {ms_save / 1e3:.3f} s; "
            f"save_async blocks the caller {ms_block / 1e3:.3f} s, its "
            f"writer ends {s_write:.3f} s later; restore "
            f"{ms_restore / 1e3:.3f} s; peak device memory {peak:.2f} GiB")
        del srv
    torch.cuda.empty_cache()


def twin_arm():
    """The reference bench's twin shape (benchmarks/paper_benches.py:695):
    20 000 x 57, dense, 10 % walking, churn 0.35 n/s, chunks of 50; ms/TTI
    of serving beside the churn-free rollout."""
    from repro_torch.core.crrm import CRRM
    from repro_torch.core.params import CRRM_parameters
    from repro_torch.mac.engine import Draws, seed_churn_state
    from repro_torch.sim.mobility import ChurnConfig
    from repro_torch.twin.server import TwinServer
    n, chunk = 20_000, 50
    kw = dict(n_ues=n, n_cells=57, n_sectors=1, seed=3,
              pathloss_model_name="UMa", power_W=10.0, scheduler_policy="pf",
              fairness_p=0.5, mobility_step_m=20.0, mobility_move_frac=0.10,
              traffic_model="poisson", radio_mode="dense",
              traffic_params=dict(arrival_rate_hz=300.0,
                                  packet_size_bits=12_000.0))
    churn = ChurnConfig(arrival_rate_hz=0.35 * n, mean_lifetime_s=2.0,
                        max_arrivals_per_tti=max(8, n // 512))

    def rollout_ms(churn_cfg):
        sim = CRRM(CRRM_parameters(**kw))
        fns = sim.episode_fns(churn=churn_cfg)
        static, state = sim.episode_static(), sim.init_episode_state()
        if churn_cfg is not None:
            state = seed_churn_state(state, static, sim.params)
        fns.rollout(static, state, chunk, Draws(0, sim.device))   # warm
        return min(timed_ms(lambda: fns.rollout(
            static, state, chunk, Draws(0, sim.device)))[1]
            for _ in range(3)) / chunk

    ms_plain, ms_churn = rollout_ms(None), rollout_ms(churn)
    srv = TwinServer(CRRM(CRRM_parameters(**kw)), churn, chunk_tti=chunk)
    srv.step_chunk()                                           # warm
    ms_serve = min(timed_ms(srv.step_chunk)[1] for _ in range(4)) / chunk
    k = srv.step_chunk()
    if not (0 < k["active_ues"] < n and k["served_mbits"] > 0):
        raise AssertionError("twin arm: churn never engaged")
    log("twin", f"arm {n} x 57 dense, churn {churn.arrival_rate_hz:g}/s "
        f"cap {churn.max_arrivals_per_tti}: rollout {ms_plain:.3f} ms/TTI "
        f"without churn, {ms_churn:.3f} with (overhead x"
        f"{ms_churn / ms_plain:.3f}); TwinServer serving {ms_serve:.3f} "
        f"ms/TTI (x{ms_serve / ms_plain:.3f} of the churn-free rollout); "
        f"active_ues {k['active_ues']:.0f}")


def phase_chaos():
    """The chaos drill on the card: outage_storm at 100 000 UEs."""
    from repro_torch.robust import chaos
    with twin_dir() as td:
        kpis = chaos.drill(td, n_ues=100_000, n_cells=19, chunk=20,
                           radio_mode="incremental", inc_backend="auto")
    rec = kpis.pop("recovery")
    if not all(math.isfinite(v) for v in kpis.values()):
        raise AssertionError("chaos: non-finite KPIs")
    log("chaos", "recovery in healthy chunks: " + "; ".join(
        f"{name.split(' (')[0]} {s:.3f} s = {x:.2f}"
        for name, (s, x) in rec.items()))
    log("chaos", "CHAOS_OK: twin survived NaN injection, chunk crash and "
        "checkpoint corruption")


def fresh_peak():
    """Collect garbage, reset the peak and return the bytes still
    allocated (GiB): what an earlier phase's uncollected cycles hold, so
    that a peak read later can be told from it."""
    import gc
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    return torch.cuda.memory_allocated() / 2**30


def no_launches(phase, why="the relaxed chain is the torch one; "
                          "fused_sinr has no backward"):
    """Phases 13-14 run the relaxed (torch) chain and the dense env,
    phases 17-18 the LM: they launch neither kernel, and say so from the
    counts."""
    counts = launch_counts()
    if any(counts.values()):
        raise AssertionError(f"{phase}: kernels launched on a path that "
                             f"has none: {counts}")
    log(phase, f"launches {counts}: the path runs neither kernel ({why})")


def grad_step_ms(soft, u, reps=3):
    """Host-clock ms of one gradient step (forward and backward of the
    relaxed objective, synchronised), the median of ``reps`` after one
    warm-up."""
    times = []
    for _ in range(reps + 1):
        leaf = u.detach().requires_grad_(True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        value = soft(leaf)
        torch.autograd.grad(value, leaf)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return sorted(times[1:])[reps // 2]


def reckon_autograd_gb(n_ues, n_cells, n_freq, n_tti):
    """The float32 tensors the relaxed chain keeps per TTI for the backward
    pass, counted from its ops: the faded gain and the RSRP (n_ue, n_cell,
    n_freq) of ``rsrp``, the softmax attachment's einsum (its weights and
    the RSRP), the (n_ue, n_cell) log-RSRP softmax, and the soft CQI
    staircase's (n_ue, n_freq, 15) sigmoids with their arguments."""
    per_link_freq = 3          # faded gain, RSRP, RSRP kept by the einsum
    per_link = 4               # measurement, its log, logits, softmax
    per_ue_freq = 2 * 15 + 30  # sigmoid + argument; the MAC's (n, K) ops
    floats = n_ues * (n_cells * n_freq * per_link_freq
                      + n_cells * per_link + n_freq * per_ue_freq)
    return 4 * floats * n_tti / 2**30


def check_width_gradient(horizon, dev):
    """``relax_fixture.diffopt_check`` on the card: the port's value,
    g.v and FD errors beside the reference's; the shared horizon
    (``"held"``) holds its contract, the full one is printed."""
    import relax_fixture
    out = relax_fixture.diffopt_check(dev, horizon)
    port, ref = out["port"], out["ref"]
    g, g_j = port["grad"], ref["grad"]
    elem = float(abs(g - g_j).max() / abs(g_j).max())
    n_seg, tti = relax_fixture.HORIZONS[horizon]
    fmt = lambda errs: ", ".join(f"{e:.3g}" for e in errs)
    rel = lambda a, b: abs(a - b) / abs(b)
    log("diffopt", f"gradient at {relax_fixture.DIFFOPT['n_ues']} UEs, "
        f"{n_seg} segments x {tti} TTIs, u = 0, the reference's drop and "
        f"draws ({horizon}): value {port['value']:.7g} (reference "
        f"{ref['value']:.7g}, rel {rel(port['value'], ref['value']):.3g}), "
        f"g.v {port['gv']:.6g} (reference {ref['gv']:.6g}, rel "
        f"{rel(port['gv'], ref['gv']):.3g}), elementwise {elem:.3g} of "
        f"max|g|; FD rel err per eps {fmt(port['fd_errs'])} (reference "
        f"{fmt(ref['fd_errs'])})")
    if not math.isfinite(float(abs(g).sum())):
        raise AssertionError(f"diffopt: {horizon} gradient not finite")
    if horizon != "held":
        return
    if not (rel(port["value"], ref["value"]) <= 1e-5
            and rel(port["gv"], ref["gv"]) <= 1e-4 and elem <= 1e-4
            and min(port["fd_errs"]) <= 1e-3):
        raise AssertionError(f"diffopt: the gradient at the preset width "
                             f"parts from the reference's ({horizon})")


def phase_diffopt():
    """The differentiable engine on the card: the reference test's
    finite-difference check on its own inputs, optimize_power_plan at
    dense_urban's preset width, and a 100 000-UE gradient step."""
    sys.path.insert(0, str(Path(__file__).resolve().parent / "tests"))
    import relax_fixture
    from repro_torch.core.crrm import CRRM
    from repro_torch.rl import diffopt
    from repro_torch.sim.scenarios import make_scenario
    dev = torch.device("cuda")
    zero_counts()
    # -- tests/test_rl.py:47 on the reference's inputs, deterministic -----
    torch.use_deterministic_algorithms(True)
    try:
        for name in relax_fixture.SCENARIOS:
            gv, best, errs = relax_fixture.fd_check(name, dev)
            log("diffopt", f"FD check {name} ({relax_fixture.N_UES} UEs x "
                f"{relax_fixture.N_TTI} TTIs, the reference test's inputs, "
                f"deterministic): g.v {gv:.6g}, rel err per eps "
                + ", ".join(f"{e:.3g}" for e in errs)
                + f"; best {best:.3g} (limit 1e-3)")
            if not best <= 1e-3:
                raise AssertionError(f"diffopt: {name} autograd/FD "
                                     f"mismatch {best:.3g} > 1e-3")
    finally:
        torch.use_deterministic_algorithms(False)
    # -- optimize_power_plan's defaults at the preset width ----------------
    sim = CRRM(make_scenario("dense_urban"), device=dev)
    steps, n_seg, tti = 40, 4, 10
    res, ms_all = timed_ms(lambda: diffopt.optimize_power_plan(
        sim, n_segments=n_seg, tti_per_segment=tti, steps=steps, lr=0.1))
    h0, h_end = res.history[0], res.history[-1]
    if not all(math.isfinite(h["soft_mbps"]) for h in res.history):
        raise AssertionError("diffopt: non-finite soft objective")
    per_cell = res.power_plan.sum(dim=-1)
    if not bool((per_cell <= sim.params.power_W * (1 + 1e-5)).all()):
        raise AssertionError("diffopt: a power plan over budget")
    soft, hard = diffopt.make_power_objective(sim, tti_per_segment=tti)
    ms_grad = grad_step_ms(soft, res.u_plan)
    _, ms_hard = timed_ms(lambda: hard(res.u_plan))
    _, ms_hard = timed_ms(lambda: hard(res.u_plan))
    log("diffopt", f"dense_urban {sim.n_ues} UEs x {sim.n_cells} cells, "
        f"{n_seg} segments x {tti} TTIs, {steps} steps lr 0.1: soft "
        f"{h0['soft_mbps']:.4f} -> {h_end['soft_mbps']:.4f} Mbit/s, hard "
        f"{h0['hard_mbps']:.4f} -> {h_end['hard_mbps']:.4f} Mbit/s; "
        f"{ms_grad:.3f} ms per gradient step (forward + backward, "
        f"synchronised), {ms_hard:.3f} ms per hard scoring; the whole "
        f"optimisation {ms_all / 1e3:.2f} s")
    # the objective's gradient at this width against the reference's
    torch.use_deterministic_algorithms(True)
    try:
        for horizon in relax_fixture.HORIZONS:
            check_width_gradient(horizon, dev)
    finally:
        torch.use_deterministic_algorithms(False)
    del sim, res, soft, hard
    # -- the arm: 100 000 UEs, 2 segments x 5 TTIs ------------------------
    n_big, n_seg, tti = 100_000, 2, 5
    big = CRRM(make_scenario("dense_urban", n_ues=n_big), device=dev)
    gb = reckon_autograd_gb(n_big, big.n_cells, big.params.n_freq,
                            n_seg * tti)
    log("diffopt", f"reckoned autograd memory at {big.n_ues} UEs x "
        f"{big.n_cells} cells x {big.params.n_freq} chunks, {n_seg * tti} "
        f"TTIs: {gb:.2f} GiB of saved float32 tensors")
    if gb > 56:
        raise AssertionError("diffopt: the 100 000-UE arm would not fit")
    soft, _ = diffopt.make_power_objective(big, tti_per_segment=tti)
    u = torch.zeros((n_seg, big.n_cells, big.params.n_subbands),
                    device=dev)
    base = fresh_peak()
    ms_big = grad_step_ms(soft, u, reps=2)
    peak = torch.cuda.max_memory_allocated() / 2**30
    log("diffopt", f"{big.n_ues} UEs x {big.n_cells} cells, {n_seg} "
        f"segments x {tti} TTIs: {ms_big:.3f} ms per gradient step, peak "
        f"device memory {peak:.2f} GiB, {peak - base:.2f} GiB over the "
        f"{base:.2f} GiB held before the step (reckoned {gb:.2f} GiB for "
        f"the backward)")
    torch.cuda.synchronize()
    no_launches("diffopt")
    del big, soft
    torch.cuda.empty_cache()


#: benchmarks/BENCH_rl.json: the reference's CPU record on dense_urban and
#: its gate
RL_RECORD, RL_GATE = 1.1468, 1.05
#: the recipe of BENCH_rl.json (train_power_baseline's arguments)
RL_RECIPE = dict(n_ues=12, iterations=80, n_envs=4, n_steps=8,
                 tti_per_step=5, episode_tti=40, arrival_rate_hz=2000.0,
                 lr=1e-2, eval_every=5)


def split_iteration_ms(env, pcfg, cfg, ts, reps=2):
    """(collection ms, update ms) of one PPO iteration from ``ts``: the
    two halves of ``make_train_step`` timed apart, synchronised, medians
    of ``reps``."""
    from repro_torch.rl import ppo, rollout
    collect = rollout.make_collect_fn(env, pcfg, cfg.n_steps)
    draws = rollout.RolloutDraws(int(ts.seed), env.device)
    it = int(ts.iteration)
    coll, upd = [], []
    for _ in range(reps):
        (_, _, traj, last), ms = timed_ms(lambda: collect(
            ts.params, ts.env_states, ts.feats, draws, it))
        coll.append(ms)
        upd.append(timed_ms(lambda: ppo.ppo_update(
            pcfg, cfg, ts.params, ts.opt_state, traj, last))[1])
    return sorted(coll)[reps // 2], sorted(upd)[reps // 2]


def phase_ppo():
    """PPO on the card: BENCH_rl.json's recipe, 2 iterations at 100 000
    UEs, and a bitwise checkpoint resume."""
    from repro_torch import rl
    from repro_torch.env import CrrmEnv
    from repro_torch.rl import ppo, rollout
    from repro_torch.tree import flatten
    dev = torch.device("cuda")
    zero_counts()
    out, ms = timed_ms(lambda: ppo.train_power_baseline(
        "dense_urban", device=dev, seed=0, **RL_RECIPE))
    losses = [m["loss"] for m in out["history"]]
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError("ppo: non-finite loss")
    col_ms, upd_ms = split_iteration_ms(out["env"], out["pcfg"], out["cfg"],
                                        out["train_state"])
    best, final = out["best_uplift"], out["final_uplift"]
    log("ppo", f"train_power_baseline('dense_urban') at BENCH_rl.json's "
        f"recipe {RL_RECIPE}: best_uplift {best:.4f} (iteration "
        f"{out['best_iteration']}), final_uplift {final:.4f}; the "
        f"reference's CPU record {RL_RECORD}, its gate {RL_GATE}: "
        f"{'above' if best >= RL_GATE else 'BELOW'} the gate")
    n_it, n_ev = RL_RECIPE["iterations"], len(
        [r for r in out["history"] if "uplift" in r])
    log("ppo", f"{n_it} iterations and {n_ev} evaluations in "
        f"{ms / 1e3:.2f} s; one iteration from the final state: collection "
        f"{col_ms:.2f} ms + update {upd_ms:.2f} ms (medians of 2)")
    del out
    # -- 2 iterations at 100 000 UEs, PPOConfig's defaults ----------------
    n_big = 100_000
    base = fresh_peak()
    env = CrrmEnv(scenario="dense_urban", scenario_overrides=dict(
        n_ues=n_big, traffic_params=dict(arrival_rate_hz=2000.0,
                                         packet_size_bits=12_000.0)),
        episode_tti=40, tti_per_step=5, telemetry=True,
        reward_fn=ppo.served_tput_reward, device=dev)
    pcfg = rl.PolicyConfig(n_cells=env.n_cells, n_subbands=env.n_subbands,
                           power_W=env.max_cell_power_W, init_log_std=0.0)
    cfg = rl.PPOConfig(lr=1e-2)
    ts = rl.ppo_init(env, pcfg, cfg, seed=0)
    step = rl.make_train_step(env, pcfg, cfg)
    it_ms = []
    for _ in range(2):
        (ts, m), t = timed_ms(lambda: step(ts))
        it_ms.append(t)
        if not math.isfinite(float(m["loss"])):
            raise AssertionError("ppo: non-finite loss at 100 000 UEs")
    col_ms, upd_ms = split_iteration_ms(env, pcfg, cfg, ts)
    collect = rollout.make_collect_fn(env, pcfg, cfg.n_steps)
    draws = rollout.RolloutDraws(0, dev)
    _, per = profiled(lambda: collect(ts.params, ts.env_states, ts.feats,
                                      draws, int(ts.iteration)))
    n_ttis = cfg.n_steps * cfg.n_envs * env.tti_per_step
    launches = sum(c for _, c in per.values())
    busy = sum(us for us, _ in per.values())
    peak = torch.cuda.max_memory_allocated() / 2**30
    log("ppo", f"{env.n_ues} UEs x {env.n_cells} cells, n_envs {cfg.n_envs}, "
        f"n_steps {cfg.n_steps}, {env.tti_per_step} TTIs per step: ms per "
        f"iteration " + ", ".join(f"{t:.1f}" for t in it_ms)
        + f"; split collection {col_ms:.1f} + update {upd_ms:.1f}; "
        f"{launches / n_ttis:.1f} kernel launches and {busy / n_ttis:.1f} "
        f"device us per collected TTI ({n_ttis} TTIs); peak device memory "
        f"{peak:.2f} GiB ({base:.2f} GiB held before the env's set-up); "
        f"reward {float(m['mean_reward']):.4f}")
    del env, ts, step, collect
    torch.cuda.empty_cache()
    # -- 2 + checkpoint + restore + 2 == 4, deterministic -----------------
    env = CrrmEnv(scenario="dense_urban", scenario_overrides=dict(n_ues=12),
                  episode_tti=40, tti_per_step=5, telemetry=True,
                  reward_fn=ppo.served_tput_reward, device=dev)
    pcfg = rl.PolicyConfig(n_cells=env.n_cells, n_subbands=env.n_subbands,
                           power_W=env.max_cell_power_W)
    cfg = rl.PPOConfig(n_envs=4, n_steps=8)
    torch.use_deterministic_algorithms(True)
    try:
        with twin_dir() as td:
            ts_a, hist_a = rl.train(env, pcfg, cfg, iterations=4, seed=0)
            rl.train(env, pcfg, cfg, iterations=2, seed=0, ckpt_dir=td,
                     ckpt_every=1)
            ts_b, hist_b = rl.train(env, pcfg, cfg, iterations=4, seed=0,
                                    ckpt_dir=td, ckpt_every=1)
    finally:
        torch.use_deterministic_algorithms(False)
    keys, a = flatten(ts_a)
    b = flatten(ts_b)[1]
    if not (hist_b == hist_a[2:] and keys == flatten(ts_b)[0]
            and all(torch.equal(x, y) for x, y in zip(a, b))):
        raise AssertionError("ppo: the resumed run differs from the "
                             "uninterrupted one")
    log("ppo", f"deterministic mode: 2 iterations + checkpoint + restore + "
        f"2 equal 4 uninterrupted iterations bitwise ({len(keys)} leaves, "
        f"the history too)")
    torch.cuda.synchronize()
    no_launches("ppo")


# -- phase 15: the mesh ------------------------------------------------------
#: seconds a collective waits for a peer, and a spawn for all its ranks
MESH_TIMEOUT_S = 300
MESH_DEADLINE_S = 600
#: BENCH_sharded's shape (benchmarks/paper_benches.py::sharded_episode)
BENCH_SHARDED = dict(n_ues=100_000, n_cells=19, n_sectors=1, seed=3,
                     pathloss_model_name="UMa", power_W=10.0,
                     scheduler_policy="pf", fairness_p=0.5)
#: phase 3's sect3 field as an engine: 126 cells divide over 2 cell shards
SECT3 = dict(n_ues=100_000, n_cells=126, n_sectors=3, seed=3,
             pathloss_model_name="UMa", power_W=10.0, scheduler_policy="pf",
             fairness_p=0.5, mobility_step_m=20.0, mobility_move_frac=0.1,
             ho_enabled=True)


def bench_err(got, want):
    """``BENCH_sharded``'s measure: max |difference| / max(max |want|, 1)."""
    return float((got - want).abs().max() / want.abs().max().clamp(min=1.0))


def deterministic(fn):
    """``fn()`` in PyTorch's deterministic mode (index_add_ in a fixed
    order), switched off after."""
    torch.use_deterministic_algorithms(True)
    try:
        return fn()
    finally:
        torch.use_deterministic_algorithms(False)


def mesh_million(job):
    """Item 1: the million-UE episode of phase 6 on a 1-rank ("ue",) mesh
    (the NCCL path), against the plain rollout bit for bit in deterministic
    mode; launches of the mesh run and ms/TTI of both."""
    from repro_torch.core.crrm import CRRM
    from repro_torch.core.distributed import make_mesh
    from repro_torch.core.params import CRRM_parameters
    from repro_torch.mac.engine import Draws
    mesh = make_mesh((1,), ("ue",))
    sim = CRRM(CRRM_parameters(n_ues=1_000_000, radio_mode="incremental",
                               **EPISODE))
    plain = sim.episode_fns(inc_backend="fused")
    sharded = sim.episode_fns(inc_backend="fused", mesh=mesh)
    static, state = sim.episode_static(), sim.init_episode_state()
    n_tti = 5

    def both():
        s1, t1 = plain.rollout(static, state, n_tti, Draws(3, "cuda"))
        torch.cuda.synchronize()
        zero_counts()
        s2, t2 = sharded.rollout(static, state, n_tti, Draws(3, "cuda"))
        torch.cuda.synchronize()
        return (torch.equal(t1, t2) and leaves_equal(s1, s2),
                launch_counts()["fused_sinr"], bench_err(t2, t1))
    equal, launches, err = deterministic(both)
    return dict(equal=equal, launches=launches, n_tti=n_tti, err=err,
                ms_plain=per_tti_ms(plain, static, state, Draws(3, "cuda")),
                ms_mesh=per_tti_ms(sharded, static, state, Draws(3, "cuda")),
                peak_gib=torch.cuda.max_memory_allocated() / 2**30)


def mesh_bench(job):
    """Item 2 on a UE mesh of all the ranks: BENCH_sharded's pf episode
    (50 TTIs) against one device in deterministic mode (held), and with
    the atomics of ``index_add_`` in no fixed order (a record, beside two
    such single-device runs against each other: the card's own noise);
    ms/TTI of both; rr and max_cqi (10 TTIs) bit for bit in deterministic
    mode."""
    from repro_torch.core.crrm import CRRM
    from repro_torch.core.distributed import make_mesh
    from repro_torch.core.params import CRRM_parameters
    from repro_torch.mac.engine import Draws
    import torch.distributed as tdist
    mesh = make_mesh((tdist.get_world_size(),), ("ue",))
    out = {}
    for policy, n_tti in (("pf", 50), ("rr", 10), ("max_cqi", 10)):
        torch.cuda.reset_peak_memory_stats()
        sim = CRRM(CRRM_parameters(**dict(BENCH_SHARDED,
                                          scheduler_policy=policy)))
        plain, sharded = sim.episode_fns(), sim.episode_fns(mesh=mesh)
        static, state = sim.episode_static(), sim.init_episode_state()

        def both():
            s1, t1 = plain.rollout(static, state, n_tti, Draws(3, "cuda"))
            s2, t2 = sharded.rollout(static, state, n_tti, Draws(3, "cuda"))
            return (bench_err(t2, t1), torch.equal(t2, t1)
                    and leaves_equal(s1, s2),
                    torch.equal(s1.serving, s2.serving)
                    and torch.equal(static.a, sim.get_attachment()),
                    [bench_err(t2[:k], t1[:k]) for k in range(10, 51, 10)])
        err, equal, serving, by_tti = deterministic(both)
        out[policy] = dict(err=err, equal=equal, serving=serving,
                           n_tti=n_tti, by_tti=by_tti)
        if policy == "pf":
            _, t_a = plain.rollout(static, state, n_tti, Draws(3, "cuda"))
            _, t_b = plain.rollout(static, state, n_tti, Draws(3, "cuda"))
            out[policy].update(
                err_atomics=both()[0], err_single_twice=bench_err(t_b, t_a),
                ms_single=per_tti_ms(plain, static, state, Draws(3, "cuda")),
                ms_mesh=per_tti_ms(sharded, static, state, Draws(3, "cuda")),
                peak_gib=torch.cuda.max_memory_allocated() / 2**30)
        del sim, plain, sharded, static, state
        torch.cuda.empty_cache()
    return out


def mesh_million_pair(job):
    """Item 3: the million-UE incremental episode on a UE mesh of all the
    ranks, each patching its block's movers through fused_sinr; against
    one device in deterministic mode (per-cell served bits compare the
    attachment: a UE served from another cell moves its bits there)."""
    from repro_torch.core.crrm import CRRM
    from repro_torch.core.distributed import make_mesh
    from repro_torch.core.params import CRRM_parameters
    from repro_torch.mac.engine import Draws
    import torch.distributed as tdist
    mesh = make_mesh((tdist.get_world_size(),), ("ue",))
    torch.cuda.reset_peak_memory_stats()
    sim = CRRM(CRRM_parameters(n_ues=1_000_000, radio_mode="incremental",
                               **EPISODE))
    plain = sim.episode_fns(inc_backend="fused", telemetry=True)
    sharded = sim.episode_fns(inc_backend="fused", telemetry=True, mesh=mesh)
    static, state = sim.episode_static(), sim.init_episode_state()
    n_tti = 5

    def both():
        s1, t1, l1 = plain.rollout(static, state, n_tti, Draws(3, "cuda"))
        torch.cuda.synchronize()
        zero_counts()
        s2, t2, l2 = sharded.rollout(static, state, n_tti, Draws(3, "cuda"))
        torch.cuda.synchronize()
        launches = launch_counts()["fused_sinr"]
        cell = float(((l2.served_bits - l1.served_bits).abs()
                      / l1.served_bits.abs().clamp(min=1.0)).max())
        return (launches, bench_err(t2, t1), cell,
                torch.equal(s1.U, s2.U) and torch.equal(s1.serving,
                                                         s2.serving),
                torch.equal(l1.dirty_rows, l2.dirty_rows))
    launches, err, cell, exact, dirty = deterministic(both)
    return dict(launches=launches, n_tti=n_tti, err=err, cell_err=cell,
                exact=exact, dirty=dirty,
                ms_mesh=per_tti_ms(sharded, static, state, Draws(3, "cuda")),
                peak_gib=torch.cuda.max_memory_allocated() / 2**30)


def mesh_cells(job):
    """Item 4 on a UE x cell mesh of ``job["shape"]``: the sect3 field
    dense with A3 handover (the cross-shard argmax decides every
    handover) against one device; the fused route's refusal."""
    from repro_torch.core.crrm import CRRM
    from repro_torch.core.distributed import make_mesh
    from repro_torch.core.params import CRRM_parameters
    import dataclasses
    from repro_torch.mac.engine import Draws, make_episode_fns
    mesh = make_mesh(job["shape"], ("ue", "cell"))
    torch.cuda.reset_peak_memory_stats()
    sim = CRRM(CRRM_parameters(**SECT3))
    plain = sim.episode_fns()
    sharded = sim.episode_fns(mesh=mesh, cell_axis="cell")
    static, state = sim.episode_static(), sim.init_episode_state()
    n_tti = 5
    s1, t1 = plain.rollout(static, state, n_tti, Draws(3, "cuda"))
    s2, t2 = sharded.rollout(static, state, n_tti, Draws(3, "cuda"))
    state_err = bench_err(s2.pf_avg, s1.pf_avg)
    try:       # the fused route on the same mesh, without A3's tables
        make_episode_fns(
            dataclasses.replace(sim.params, ho_enabled=False), sim.n_ues,
            sim.n_cells, sim.radio_config(), sim._traffic_step, mesh=mesh,
            cell_axis="cell", radio_mode="incremental", inc_backend="fused",
            mobility_step_m=SECT3["mobility_step_m"])
        refusal = None
    except ValueError as e:
        refusal = str(e)
    return dict(err=bench_err(t2, t1), state_err=state_err, n_tti=n_tti,
                exact=torch.equal(s1.U, s2.U)
                and torch.equal(s1.serving, s2.serving)
                and torch.equal(s1.ttt, s2.ttt),
                handovers=int((s1.serving != static.a).sum()),
                refusal=refusal,
                ms_single=per_tti_ms(plain, static, state, Draws(3, "cuda")),
                ms_mesh=per_tti_ms(sharded, static, state, Draws(3, "cuda")),
                peak_gib=torch.cuda.max_memory_allocated() / 2**30)


def mesh_steps(job):
    """Item 5: the three step makers of ``core.distributed`` on a (1, 2)
    mesh at 100 000 UEs x 126 cells, K = 2, against the port's
    single-device CRRM on the same inputs."""
    import numpy as np
    from repro_torch.core import distributed as D
    from repro_torch.core.crrm import CRRM
    from repro_torch.core.params import CRRM_parameters
    from repro_torch.sim import phy
    from repro_torch.sim.pathloss import make_pathloss
    n, m, k, extent = 100_000, 126, 2, 8000.0
    rng = np.random.default_rng(11)
    U = np.column_stack([rng.uniform(0, extent, (n, 2)),
                         np.full((n, 1), 1.5)]).astype(np.float32)
    C = np.column_stack([rng.uniform(0, extent, (m, 2)),
                         np.full((m, 1), 25.0)]).astype(np.float32)
    Pw = np.full((m, k), 5.0, np.float32)
    params = CRRM_parameters(n_ues=n, ue_positions=U, cell_positions=C,
                             power_matrix=Pw, n_subbands=k,
                             pathloss_model_name="UMa")
    ref = CRRM(params)
    g1, a1 = ref.get_SINR().clone(), ref.get_attachment().clone()
    t1 = ref.throughput.update().clone()
    w1, u1 = ref.w.update().clone(), ref.u.update().clone()
    Ut, Ct, Pt = (torch.as_tensor(x, device="cuda") for x in (U, C, Pw))
    mesh = D.make_mesh((1, 2), ("data", "model"))
    args = (mesh, make_pathloss("UMa").get_pathgain, params.subband_noise_W,
            m, params.subband_bandwidth_Hz, 0.0)
    out = {}
    for name in ("materialized", "streaming"):
        gamma, a, tput = getattr(D, f"make_{name}_step")(*args)(Ut, Ct, Pt)
        out[f"make_{name}_step"] = sinr_tput_errors(
            gamma, a, tput, g1, a1, t1, w1, u1, params.subband_noise_W, phy)
    # incremental: 1 000 rows move; the single device moves them too
    g = np.random.default_rng(12)
    idx = g.choice(n, 1000, replace=False).astype(np.int32)
    new = np.column_stack([g.uniform(0, extent, (1000, 2)),
                           np.full((1000, 1), 1.5)]).astype(np.float32)
    R = ref.get_RSRP()
    bv = R.sum(dim=2).max(dim=1).values
    f = D.make_incremental_rows_step(*args)
    U2, w2, u2, a2, bv2, t2 = f(Ut, Ct, Pt, w1, u1, a1, bv,
                                torch.as_tensor(idx, device="cuda"),
                                torch.as_tensor(new, device="cuda"))
    ref.move_UEs(idx, new)
    out["make_incremental_rows_step"] = sinr_tput_errors(
        w2 / (params.subband_noise_W + u2), a2, t2, ref.get_SINR(),
        ref.get_attachment(), ref.throughput.update(), ref.w.update(),
        ref.u.update(), params.subband_noise_W, phy)
    return out


def sinr_tput_errors(gamma, a, tput, g1, a1, t1, w1, u1, noise_w, phy):
    """The SINR and throughput errors of a step maker against the single
    device: the flat max relative SINR error, the entries past rtol 1e-3
    and whether each lies within rtol 1e-5 times the condition number of
    w / (noise + total - w) (the psum reorders total; where w dominates,
    u = total - w is a small difference of two large sums); the entries
    whose CQI differs (a step straddled) and the throughput error on the
    others."""
    rel = (gamma - g1).abs() / g1.abs().clamp(min=1e-30)
    w64, u64 = w1.double(), u1.double()
    kappa = 1.0 + (2 * w64 + u64) / (noise_w + u64)
    past = rel > 1e-3
    within = bool(((gamma - g1).abs().double()
                   <= 1e-5 * kappa * g1.abs().double())[past].all())
    straddle = (phy.sinr_db_to_cqi(phy.sinr_to_db(gamma))
                != phy.sinr_db_to_cqi(phy.sinr_to_db(g1)))
    keep = ~straddle.any(dim=1)
    d = (tput - t1).abs()[keep]
    return dict(attach=bool(torch.equal(a, a1)), sinr_rel=float(rel.max()),
                past=int(past.sum()), past_within=within,
                max_kappa=float(kappa[past].max()) if past.any() else 0.0,
                straddle=int(straddle.sum()),
                tput_rel=float((d / t1.abs()[keep].clamp(min=1.0)).max()),
                tput_ok=bool((d <= 1e-3 * t1.abs()[keep] + 1.0).all()))


MESH_JOBS = {"million": mesh_million, "bench": mesh_bench,
             "million_pair": mesh_million_pair, "cells": mesh_cells,
             "steps": mesh_steps}


def _mesh_rank(rank, world, backend, d, jobs):
    """One rank: join the group (with a timeout), run ``jobs`` in order,
    write the outputs; on any failure write the traceback and exit 1."""
    import datetime
    import traceback
    import torch.distributed as tdist
    try:
        torch.cuda.set_device(0)
        tdist.init_process_group(
            backend, store=tdist.FileStore(f"{d}/store", world), rank=rank,
            world_size=world,
            timeout=datetime.timedelta(seconds=MESH_TIMEOUT_S))
        try:
            out = [MESH_JOBS[j["name"]](j) for j in jobs]
        finally:
            tdist.destroy_process_group()
        torch.save(out, f"{d}/rank{rank}.pt")
    except BaseException:
        with open(f"{d}/rank{rank}.err", "w") as f:
            f.write(f"rank {rank}:\n{traceback.format_exc()}")
        raise SystemExit(1)


def spawn_ranks(world, backend, jobs):
    """Run ``jobs`` on ``world`` ranks of ``backend`` sharing the card,
    started with torch.multiprocessing's spawn; every rank is joined
    against one deadline and killed past it.  A failed rank raises."""
    import tempfile
    import torch.multiprocessing as tmp
    root = Path(__file__).resolve().parent / "build"
    root.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(prefix="mesh-", dir=root) as d:
        ctx = tmp.get_context("spawn")
        procs = [ctx.Process(target=_mesh_rank,
                             args=(r, world, backend, d, jobs))
                 for r in range(world)]
        for p in procs:
            p.start()
        end = time.monotonic() + MESH_DEADLINE_S
        try:
            while any(p.is_alive() for p in procs):
                if any(p.exitcode not in (None, 0) for p in procs):
                    break
                if time.monotonic() > end:
                    raise TimeoutError(f"mesh ranks still running after "
                                       f"{MESH_DEADLINE_S} s")
                time.sleep(0.1)
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                p.join(30)
        errs = [Path(d, f"rank{r}.err").read_text() for r in range(world)
                if Path(d, f"rank{r}.err").exists()]
        if errs or any(p.exitcode != 0 for p in procs):
            raise RuntimeError(f"mesh ranks failed (exit codes "
                               f"{[p.exitcode for p in procs]}):\n"
                               + "\n".join(errs))
        return [torch.load(f"{d}/rank{r}.pt", weights_only=False)
                for r in range(world)]


def phase_mesh(smi, ms_phase6):
    """Phase 15: the mesh, on the one card.  NCCL as a 1-rank group; the
    multi-rank runs as gloo ranks sharing the card with CUDA tensors (NCCL
    refuses two ranks on one GPU), so their times are a record only."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    (one,), = spawn_ranks(1, "nccl", [dict(name="million")])
    log("mesh", f"1. nccl, 1 rank ({smi}): the 1M x 127 incremental episode "
        f"on a ('ue',) mesh of 1: fused_sinr launches {one['launches']} "
        f"over {one['n_tti']} TTIs ({one['launches'] / one['n_tti']:g} per "
        f"TTI); equal to the plain rollout bit for bit in deterministic "
        f"mode: {one['equal']}; {one['ms_mesh']:.3f} ms/TTI on the mesh, "
        f"{one['ms_plain']:.3f} plain in the same rank, {ms_phase6:.3f} in "
        f"phase 6; peak {one['peak_gib']:.2f} GiB")
    if not one["equal"] or one["launches"] != one["n_tti"]:
        raise AssertionError(f"mesh 1: {one}")
    pair = spawn_ranks(2, "gloo", [
        dict(name="bench"), dict(name="million_pair"),
        dict(name="cells", shape=(1, 2)), dict(name="steps")])
    for r, (bench, million, cells, steps) in enumerate(pair):
        pf = bench["pf"]
        log("mesh", f"2. gloo, rank {r} of 2 on one card ({smi}): "
            f"BENCH_sharded 100000 x 19 pf 50 TTIs: err {pf['err']:.3e} "
            f"(max |d| / max(max |tput|, 1), limit 1e-5) in deterministic "
            f"mode; {pf['err_atomics']:.3e} with index_add_'s atomics in no "
            f"fixed order, where two single-device runs differ by "
            f"{pf['err_single_twice']:.3e}; deterministic err over the "
            f"first 10, 20, .. TTIs: "
            f"{', '.join(f'{e:.2e}' for e in pf['by_tti'])}; serving "
            f"{'exact' if pf['serving'] else 'DIFFERS'}; {pf['ms_mesh']:.3f} "
            f"ms/TTI sharded, {pf['ms_single']:.3f} single; peak "
            f"{pf['peak_gib']:.2f} GiB; rr 10 TTIs bitwise "
            f"{bench['rr']['equal']}, max_cqi 10 TTIs bitwise "
            f"{bench['max_cqi']['equal']}")
        log("mesh", f"3. gloo, rank {r} of 2: 1M incremental on a UE mesh "
            f"of 2: fused_sinr launches {million['launches']} over "
            f"{million['n_tti']} TTIs; err {million['err']:.3e}, per-cell "
            f"served bits {million['cell_err']:.3e}, positions and serving "
            f"exact {million['exact']}, dirty rows equal {million['dirty']}; "
            f"{million['ms_mesh']:.3f} ms/TTI ({smi}); peak "
            f"{million['peak_gib']:.2f} GiB")
        log("mesh", f"4. gloo, rank {r} of 2: UE x cell (1, 2), sect3 "
            f"100000 x 126 dense with A3, 5 TTIs: err {cells['err']:.3e}, "
            f"pf_avg {cells['state_err']:.3e}, positions/serving/ttt exact "
            f"{cells['exact']} ({cells['handovers']} UEs handed over); "
            f"{cells['ms_mesh']:.3f} ms/TTI sharded, {cells['ms_single']:.3f} "
            f"single ({smi}); peak {cells['peak_gib']:.2f} GiB; fused "
            f"refused: {cells['refusal']}")
        for name, e in steps.items():
            log("mesh", f"5. gloo, rank {r} of 2: {name} (1, 2) "
                f"100000 x 126, K = 2: attachment exact {e['attach']}; SINR "
                f"max rel err {e['sinr_rel']:.3e}, {e['past']} entries past "
                f"rtol 1e-3, all within 1e-5 x condition number "
                f"{e['past_within']} (largest {e['max_kappa']:.3g}); "
                f"{e['straddle']} entries straddle a CQI step; throughput max "
                f"rel err {e['tput_rel']:.3e} on the rest (rtol 1e-3, atol 1)")
        bad = [f"2 {p}" for p in ("pf", "rr", "max_cqi")
               if not bench[p]["serving"]]
        bad += ["2 pf err"] if pf["err"] > 1e-5 else []
        bad += [f"2 {p} bitwise" for p in ("rr", "max_cqi")
                if not bench[p]["equal"]]
        bad += ["3 launches"] if million["launches"] != million["n_tti"] \
            else []
        bad += ["3 err"] if max(million["err"], million["cell_err"]) > 1e-5 \
            or not million["exact"] or not million["dirty"] else []
        bad += ["4"] if cells["err"] > 1e-5 or cells["state_err"] > 1e-5 \
            or not cells["exact"] or cells["refusal"] is None else []
        bad += [f"5 {n}" for n, e in steps.items()
                if not (e["attach"] and e["past_within"] and e["tput_ok"])]
        if bad:
            raise AssertionError(f"mesh rank {r}: {bad}")
    quad = spawn_ranks(4, "gloo", [dict(name="cells", shape=(2, 2))])
    for r, (cells,) in enumerate(quad):
        log("mesh", f"4. gloo, rank {r} of 4: UE x cell (2, 2), the same "
            f"episode: err {cells['err']:.3e}, pf_avg "
            f"{cells['state_err']:.3e}, positions/serving/ttt exact "
            f"{cells['exact']}; {cells['ms_mesh']:.3f} ms/TTI sharded, "
            f"{cells['ms_single']:.3f} single ({smi}); peak "
            f"{cells['peak_gib']:.2f} GiB")
        if cells["err"] > 1e-5 or cells["state_err"] > 1e-5 \
                or not cells["exact"]:
            raise AssertionError(f"mesh (2, 2) rank {r}: {cells}")
    log("mesh", f"phase 15 in {time.perf_counter() - t0:.1f} s; times of "
        f"ranks sharing one card are a record, not a multi-GPU scaling")
    return one



def ppp_near_ties(U, C, Pw, dryrun):
    """``near_tie_mask`` of the crrm-ppp network's power-law field."""
    from repro_torch.sim.pathloss import make_pathloss
    return near_tie_mask(U, C, Pw, torch.zeros(C.shape[0], device=U.device),
                         None, make_pathloss("power_law", alpha=dryrun.ALPHA),
                         1, False)


def hold_rows(mesh, U, C, Pw, gamma, a, dryrun):
    """A streamed cell's rows held to the materialised step over the same
    rows (a row's attachment and SINR depend on its own position only):
    attachment exact off near ties (``near_tie_mask``), SINR within 1e-5
    times the condition number of w / (noise + total - w), with w and u
    from the incremental step over the rows."""
    m, k = C.shape[0], Pw.shape[1]
    g_m, a_m, _ = dryrun.make_step("materialized", mesh, m, k)(U, C, Pw)
    w, u, _, _ = dryrun.initial_state(dryrun.make_step(
        "incremental", mesh, m, k, dryrun.DEFAULT_TILE), U, C, Pw)
    ties = ppp_near_ties(U, C, Pw, dryrun)
    w64, u64 = w.double(), u.double()
    kappa = 1.0 + (2 * w64 + u64) / (dryrun.NOISE_W + u64)
    err = (gamma.double() - g_m.double()).abs() / (kappa * g_m.double().abs())
    return dict(rows=U.shape[0], ties=int(ties.sum()),
                bad=int(((a != a_m) & ~ties).sum()),
                err_kappa=float(err.max()))


def ppp_cells(smi):
    """The three crrm-ppp cells through ``launch.dryrun.run_crrm_cell`` on
    a 1-rank NCCL group, each held by the repo's own means."""
    import gc
    from repro_torch.configs import crrm_ppp
    from repro_torch.core import distributed as D
    from repro_torch.launch import dryrun
    from repro_torch.sim import phy
    gc.collect()
    torch.cuda.empty_cache()
    dev = torch.device("cuda")
    card_gib = torch.cuda.get_device_properties(0).total_memory / 2**30
    out_dir = str(Path(__file__).resolve().parent / "artifacts" / "dryrun")
    with dryrun.one_rank_group(dev):
        mesh = D.make_mesh((1, 1), ("data", "model"), dev)
        for shape, sh in crrm_ppp.SHAPES.items():
            t0 = time.perf_counter()
            art, out = dryrun.run_crrm_cell(shape, mesh, "cuda-1x1", out_dir,
                                            force=True)
            n, m, k = sh["n_ues"], sh["n_cells"], sh["n_subbands"]
            peak = art["peak_bytes_per_device"] / 2**30
            setup = art.get("setup")
            log("report", f"crrm-ppp {shape} ({art['variant']}, {n} x {m}, "
                f"K = {k}{', %d moves' % sh['max_moves'] if 'max_moves' in sh else ''}"
                f"; {smi}): device {art['device_ms']:.1f} ms, wall "
                f"{art['wall_ms']:.1f} ms for one step"
                + (f" after a set-up of {setup['device_ms']:.1f} ms"
                   if setup else "")
                + f"; peak {peak:.2f} GiB of {card_gib:.2f} (reckoned "
                f"{art['reckoned_bytes'] / 2**30:.2f}); analytic flops "
                f"{art['analytic_flops']:.4e}, bytes "
                f"{art['analytic_bytes']:.4e}; all-reduces "
                f"{art['collective_counts']}, wire bytes "
                f"{art['collective_wire_bytes']:g}; tiles "
                f"{art.get('cell_tile', '-')}/{art.get('setup_tile', '-')}")
            for cut in art["reduced"]:
                log("report", f"  reduced: {cut}")
            log("report", "  " + art["roofline_row"])
            if peak >= card_gib:
                raise AssertionError(f"{shape}: peak {peak:.2f} GiB")
            field = {name: torch.as_tensor(x, device=dev) for name, x in
                     dryrun.cell_field(sh, art["seed"]).items()}
            U, C, Pw = field["U"], field["C"], field["Pw"]
            if art["variant"] == "incremental":
                U2, w2, u2, a2, bv2, tput = out
                gamma, a = w2 / (dryrun.NOISE_W + u2), a2
                rows = field["idx"].long()
                if not torch.equal(U2[rows], field["new_pos"]):
                    raise AssertionError(f"{shape}: moved rows not moved")
            else:
                gamma, a, tput = out
                rows = torch.randperm(n, generator=torch.Generator(
                    device=dev).manual_seed(1), device=dev)[:4096]
            if not (gamma.shape == (n, k) and tput.shape == (n, k)
                    and a.shape == (n,) and torch.isfinite(gamma).all()
                    and torch.isfinite(tput).all()
                    and int(a.min()) >= 0 and int(a.max()) < m):
                raise AssertionError(f"{shape}: misshapen or non-finite "
                                     f"outputs")
            held = hold_rows(mesh, (U2 if art["variant"] == "incremental"
                                    else U)[rows].contiguous(), C, Pw,
                             gamma[rows], a[rows], dryrun)
            log("report", f"  {held['rows']} rows held to the materialised "
                f"step: attachment differs off near ties on {held['bad']} "
                f"({held['ties']} near ties), SINR max err "
                f"{held['err_kappa']:.2e} x kappa (limit 1e-5)")
            if held["bad"] or held["err_kappa"] > 1e-5:
                raise AssertionError(f"{shape}: {held}")
            if shape == "net_256k":
                # the step again, warm, under the package's trace
                mat = dryrun.make_step("materialized", mesh, m, k)
                wall, per = profiled(lambda: mat(U, C, Pw))
                log_breakdown("report", "net_256k step", wall * 1e6, per,
                              top=6)
                stream = dryrun.make_step("streaming", mesh, m, k,
                                          dryrun.DEFAULT_TILE)
                g_s, a_s, t_s = stream(U, C, Pw)
                w_s, u_s, _, _ = dryrun.initial_state(dryrun.make_step(
                    "incremental", mesh, m, k, dryrun.DEFAULT_TILE), U, C,
                    Pw)
                ties = ppp_near_ties(U, C, Pw, dryrun)
                bad = int(((a != a_s) & ~ties).sum())
                e = sinr_tput_errors(gamma, a, tput, g_s, a_s, t_s, w_s, u_s,
                                     dryrun.NOISE_W, phy)
                log("report", f"  net_256k materialised vs streaming "
                    f"(tile {dryrun.DEFAULT_TILE}) on the same field: "
                    f"attachment exact {e['attach']}, {bad} rows differ off "
                    f"{int(ties.sum())} near ties; SINR max rel err "
                    f"{e['sinr_rel']:.3e}, {e['past']} entries past rtol "
                    f"1e-3, all within 1e-5 x kappa {e['past_within']} "
                    f"(largest {e['max_kappa']:.3g}); {e['straddle']} "
                    f"straddle a CQI step; throughput max rel err "
                    f"{e['tput_rel']:.3e} on the rest")
                if bad or not (e["past_within"] and e["tput_ok"]):
                    raise AssertionError(f"net_256k vs streaming: {bad}, {e}")
                del g_s, a_s, t_s, w_s, u_s, ties
            log("report", f"  {shape} in {time.perf_counter() - t0:.1f} s")
            del art, out, field, U, C, Pw, gamma, a, tput
            gc.collect()
            torch.cuda.empty_cache()


def phase_report(smi):
    """Phase 16: the package's own observability on the card -- the
    episode report of the million-UE episode, a Chrome trace of one TTI
    read back, a stage timer, then the crrm-ppp cells."""
    import tempfile
    from repro_torch.analysis import roofline
    from repro_torch.core.crrm import CRRM
    from repro_torch.core.params import CRRM_parameters
    from repro_torch.mac.engine import Draws
    from repro_torch.obs import StageTimer, annotate, profile, report, trace
    t_phase = time.perf_counter()
    n_tti = 5
    sim = CRRM(CRRM_parameters(n_ues=1_000_000, radio_mode="incremental",
                               **EPISODE))
    # -- the main path: counts to 0 just before, read just after ----------
    torch.cuda.synchronize()
    zero_counts()
    art = report.episode_report(sim, n_tti, scenario="million_episode",
                                inc_backend="fused")
    counts = launch_counts()
    r = roofline.from_artifact(art)
    log("report", f"episode_report 1M x 127 incremental fused, {n_tti} TTIs "
        f"({smi}): launches {counts} (the report's own count "
        f"{art['kernel_launches']}); analytic flops "
        f"{art['analytic_flops']:.4e}, bytes {art['analytic_bytes']:.4e} "
        f"(rows {art['analytic_breakdown']['rows_init']} once, "
        f"{art['analytic_breakdown']['rows_per_tti']} per TTI); measured "
        f"device {art['device_ms_per_tti']:.3f} ms/TTI, wall "
        f"{art['wall_ms_per_tti']:.3f} ms/TTI (set-up included), "
        f"{art['launches_per_tti']:.1f} device kernels per TTI; roofline "
        f"bound {r.bound_s * 1e3 / n_tti:.3f} ms/TTI ({r.dominant})")
    log("report", "  " + roofline.format_row("million_episode", art))
    if counts["fused_sinr"] != n_tti or \
            art["kernel_launches"]["fused_sinr"] != n_tti:
        raise AssertionError(f"episode_report: {counts}, "
                             f"{art['kernel_launches']}")
    if not (art["device_ms_per_tti"] > 0 and art["backend"] == "cuda"
            and art["collective_wire_bytes"] == 0.0):
        raise AssertionError(f"episode_report artifact: {art}")
    # -- one TTI under the trace, with spans and a stage timer ------------
    fns = sim.episode_fns(inc_backend="fused")
    timer = StageTimer()
    with tempfile.TemporaryDirectory(prefix="trace-") as d:
        with trace(d):
            with annotate("prepare"):
                static, state = timer.time("prepare", lambda: (
                    sim.episode_static(), sim.init_episode_state()))
            with annotate("rollout"):
                timer.time("rollout", fns.rollout, static, state, 1,
                           Draws(3, "cuda"))
            with annotate("sync"), timer.stage("sync"):
                torch.cuda.synchronize()
        path = Path(d) / profile.TRACE_FILE
        size = path.stat().st_size
        events = json.loads(path.read_text())["traceEvents"]
    names = {e.get("name", "") for e in events}
    kernels = [e["name"] for e in events
               if str(e.get("cat", "")).lower() == "kernel"]
    fused = [k for k in kernels if "fused_sinr" in k]
    log("report", f"Chrome trace of one TTI ({size} bytes, {len(events)} "
        f"events, {len(kernels)} kernel events): spans prepare/rollout/sync "
        f"{[x in names for x in ('prepare', 'rollout', 'sync')]}; "
        f"fused_sinr kernel events {len(fused)} ({fused[:1]})")
    if not {"prepare", "rollout", "sync"} <= names or len(fused) != 1:
        raise AssertionError(f"trace: categories "
                             f"{sorted({str(e.get('cat')) for e in events})}")
    log("report", f"stage timer of the same TTI ({smi}):\n"
        + timer.report("[report]   "))
    del sim, fns, static, state
    ppp_cells(smi)
    log("report", f"phase 16 in {time.perf_counter() - t_phase:.1f} s")


#: the larger serving arm: slots, prompt tokens, new tokens
SERVE_ARM = dict(slots=32, prompt=512, new=64)
#: full configs served on the card (f32 params: granite 5.5 GB, zamba2
#: 4.7, yi 24.2, codeqwen 32.8, falcon-mamba 29.1) ...
SERVE_FULL = ("granite-moe-1b-a400m", "zamba2-1.2b", "yi-6b",
              "codeqwen1.5-7b", "falcon-mamba-7b")
#: ... and those whose f32 params exceed the card or leave no room
SERVE_TOO_BIG = ("deepseek-moe-16b", "deepseek-67b", "qwen2-vl-72b")


def timed_arch(arch, timer):
    """``arch`` whose prefill and decode_step run under ``timer``'s stages
    ``prefill`` / ``decode`` (synchronised on their outputs)."""
    import dataclasses
    return dataclasses.replace(
        arch,
        prefill=lambda p, b, m: timer.time("prefill", arch.prefill, p, b, m),
        decode_step=lambda p, b, c, pos: timer.time(
            "decode", arch.decode_step, p, b, c, pos))


def serve_timed(eng, prompts, max_new):
    """One ``ServeEngine.run`` over ``prompts``: (its output, wall s, ms
    per prefill, ms per decode step, prefills, decode steps)."""
    from repro_torch.obs import StageTimer
    timer = StageTimer()
    arch = eng.arch
    eng.arch = timed_arch(arch, timer)
    for p in prompts:
        eng.submit(p, max_new_tokens=max_new)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = eng.run()
    wall = time.perf_counter() - t0
    eng.arch = arch
    n_pre, n_dec = timer.calls("prefill"), timer.calls("decode")
    return (out, wall, timer.total_s("prefill") * 1e3 / max(n_pre, 1),
            timer.total_s("decode") * 1e3 / max(n_dec, 1), n_pre, n_dec)


def serve_full_configs(smi):
    """Every LM config that fits the card in f32 params, served whole:
    2 requests x 8 new tokens, finite logits, two greedy runs equal."""
    import gc

    import lm_fixture
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.models import transformer
    from repro_torch.models.registry import make_arch
    from repro_torch.serve.engine import ServeEngine
    budget = torch.cuda.mem_get_info()[1]
    for arch_id in SERVE_TOO_BIG:
        cfg = get_config(arch_id)
        meta = transformer.init_params(torch.Generator(), cfg, device="meta")
        log("serve", f"{arch_id}: not served: its f32 params reckon "
            f"{transformer.param_bytes(meta) / 1e9:.1f} GB "
            f"({transformer.param_count(meta) / 1e9:.2f} B params) of the "
            f"card's {budget / 1e9:.1f} GB")
    for arch_id in SERVE_FULL:
        cfg = get_config(arch_id)
        base = fresh_peak()
        t0 = time.perf_counter()
        eng = ServeEngine(make_arch(cfg), batch_slots=2, max_len=64, seed=0)
        torch.cuda.synchronize()
        t_init = time.perf_counter() - t0
        steps: list = []
        eng.arch = lm_fixture.recording(eng.arch, steps)
        runs = []
        for _ in range(2):
            for n in (5, 9):
                eng.submit(np.arange(n) % cfg.vocab_size, max_new_tokens=8)
            t1 = time.perf_counter()
            runs.append(eng.run()["results"])
            wall = time.perf_counter() - t1
        finite = all(np.isfinite(x).all() for x in steps)
        log("serve", f"{arch_id} full ({cfg.family}, {cfg.n_layers} layers, "
            f"d_model {cfg.d_model}, {cfg.dtype} compute, "
            f"{transformer.param_bytes(eng.params) / 1e9:.2f} GB f32 params; "
            f"{smi}): init {t_init:.2f} s, a run of 2 x 8 tokens "
            f"{wall:.3f} s; finite logits {finite}; greedy runs equal "
            f"{runs[0] == runs[1]}; peak "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB (held "
            f"before: {base:.2f}); tokens {runs[0]}")
        if not finite or runs[0] != runs[1] or \
                [len(t) for t in runs[0].values()] != [8, 8]:
            raise AssertionError(f"serve {arch_id}: {runs}")
        del eng, steps
        gc.collect()
        torch.cuda.empty_cache()


#: phase 17's timed runs at launch.serve's defaults: (engine, label)
SERVE_ORDER = (("unsharded", "warm-up"), ("(1, 1) mesh", "warm-up"),
               ("unsharded", "measured"), ("(1, 1) mesh", "measured"),
               ("(1, 1) mesh", "measured again"),
               ("unsharded", "measured again"))


def phase_serve(smi):
    """Phase 17: the LM serving path on the card -- qwen1.5-0.5b at full
    width held to the reference's fixture, ``launch.serve``'s defaults
    (the unsharded engine beside the (1, 1) mesh engine it serves
    through, at the same shapes), a larger arm, one profiled decode step, the full configs."""
    import gc

    import numpy as np
    sys.path.insert(0, str(Path(__file__).resolve().parent / "tests"))
    import lm_fixture
    from repro_torch.analysis import roofline
    from repro_torch.launch import dryrun
    from repro_torch.launch import serve as launch_serve
    from repro_torch.models import transformer
    from repro_torch.models.registry import make_arch
    from repro_torch.parallel.mesh import make_host_mesh
    from repro_torch.serve.engine import ServeEngine
    t_phase = time.perf_counter()
    # -- the main path: counts to 0 just before, read just after ----------
    torch.cuda.synchronize()
    zero_counts()
    # qwen1.5-0.5b at full width on the fixture's seeded weights
    t0 = time.perf_counter()
    tree = lm_fixture.param_tree(lm_fixture.config("float32"))
    log("serve", f"fixture weights (numpy seed {lm_fixture.SEED}) built in "
        f"{time.perf_counter() - t0:.1f} s")
    for dtype in lm_fixture.DTYPES:
        t0 = time.perf_counter()
        res = lm_fixture.check(torch.device("cuda"), dtype, tree)
        log("serve", f"qwen1.5-0.5b full width, {dtype} compute, held to "
            f"the reference's fixture ({smi}): {res['held_steps']} slot "
            f"steps held, logits max |d| {res['max_err']:.3e} (tol "
            f"{lm_fixture.TOL[dtype]}), near ties {res['near_ties']} "
            f"(margin < {lm_fixture.NEAR_TIE[dtype]}), parted "
            f"{res['parted']}; tokens {res['tokens']}; "
            f"{time.perf_counter() - t0:.1f} s")
    del tree
    gc.collect()
    torch.cuda.empty_cache()
    # launch.serve's defaults through its entry point (the card by default)
    out = launch_serve.main([])
    log("serve", f"python -m repro_torch.launch.serve (defaults: 8 "
        f"requests, 16 new, 4 slots, max_len 128): {out['n_tokens']} tokens "
        f"at {out['tokens_per_s']:.1f} tok/s (cold: the first run of the "
        f"process)")
    cfg = lm_fixture.config("bfloat16")
    arch = make_arch(cfg)
    eng = ServeEngine(arch, batch_slots=4, max_len=128)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, rng.integers(4, 24))
               for _ in range(8)]
    base = fresh_peak()
    # the unsharded engine and launch.serve's (1, 1) mesh engine (the same
    # seeded params) at the same shapes, interleaved
    with dryrun.one_rank_group(torch.device(CARD)):
        engines = {"unsharded": eng, "(1, 1) mesh": ServeEngine(
            arch, make_host_mesh(1, 1, device=CARD), batch_slots=4,
            max_len=128)}
        tokens = {}
        for name, label in SERVE_ORDER:
            o, wall, ms_pre, ms_dec, n_pre, n_dec = serve_timed(
                engines[name], prompts, 16)
            tokens.setdefault(name, [t for _, t in
                                     sorted(o["results"].items())])
            log("serve", f"launch.serve defaults, {name} engine, {label} "
                f"run ({smi}): {o['n_tokens']} tokens in {wall:.3f} s = "
                f"{o['tokens_per_s']:.1f} tok/s; {n_pre} prefills at "
                f"{ms_pre:.2f} ms, {n_dec} decode steps at {ms_dec:.3f} ms;"
                f" peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB"
                f" (held before: {base:.2f})")
        del engines
    if tokens["unsharded"] != tokens["(1, 1) mesh"]:
        raise AssertionError("serve: the (1, 1) mesh engine's tokens part "
                             "from the unsharded engine's")
    # one decode step under the package's trace, beside its byte bound
    tokens = torch.as_tensor(np.stack([np.arange(20) % cfg.vocab_size] * 4),
                             device="cuda")
    last, caches = arch.prefill(eng.params, {"tokens": tokens}, 128)
    step = {"tokens": torch.argmax(last[:, -1], -1)[:, None].to(torch.int32)}
    arch.decode_step(eng.params, step, caches, 20)
    wall, per = profiled(lambda: arch.decode_step(eng.params, step, caches,
                                                  21))
    log_breakdown("serve", "decode step", wall * 1e6, per)
    pbytes = transformer.param_bytes(eng.params)
    log("serve", f"decode step byte bound: {pbytes / 1e9:.3f} GB of f32 "
        f"params read once / {roofline.HBM_BW / 1e12:.2f} TB/s = "
        f"{pbytes / roofline.HBM_BW * 1e3:.3f} ms (the step above casts "
        f"every weight to bf16 at its use, as the reference does)")
    del eng, caches, last
    gc.collect()
    # the larger arm
    arm = SERVE_ARM
    eng = ServeEngine(arch, batch_slots=arm["slots"],
                      max_len=arm["prompt"] + arm["new"])
    prompts = [rng.integers(0, cfg.vocab_size, arm["prompt"])
               for _ in range(arm["slots"])]
    base = fresh_peak()
    o, wall, ms_pre, ms_dec, n_pre, n_dec = serve_timed(eng, prompts,
                                                        arm["new"])
    kv = sum(c.numel() * c.element_size() for c in arch.init_cache(
        arm["slots"], arm["prompt"] + arm["new"], device="meta").values())
    log("serve", f"larger arm, {arm['slots']} slots x {arm['prompt']}-token "
        f"prompts x {arm['new']} new ({smi}): {o['n_tokens']} tokens in "
        f"{wall:.3f} s = {o['tokens_per_s']:.1f} tok/s; prefill "
        f"{ms_pre:.1f} ms ({arm['slots'] * arm['prompt']} tokens), {n_dec} "
        f"decode steps at {ms_dec:.3f} ms (bound: params + the whole "
        f"{kv / 2**30:.2f} GiB cache read once = "
        f"{(pbytes + kv) / roofline.HBM_BW * 1e3:.3f} ms); peak "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB (held before: "
        f"{base:.2f})")
    if o["n_tokens"] != arm["slots"] * arm["new"]:
        raise AssertionError(f"larger arm: {o['n_tokens']} tokens")
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    serve_full_configs(smi)
    no_launches("serve", "the LM serving path has no hand-written kernel")
    log("serve", f"phase 17 in {time.perf_counter() - t_phase:.1f} s")


#: the timed training arm (tokens a step: 16 384) and the full configs
#: trained one step at full width (f32 AdamW state: 16 bytes a param)
TRAIN_ARM = dict(batch=8, seq=2048)
TRAIN_FULL = ("granite-moe-1b-a400m", "zamba2-1.2b", "seamless-m4t-large-v2")
TRAIN_FULL_SHAPE = dict(batch=2, seq=256)
#: flash's backward at length: causal, b 1, 16 heads, hd 64, the config's
#: chunks (512 / 1024: 8 x 4 blocks)
FLASH_LONG = dict(b=1, s=4096, h=16, hd=64, cq=512, ckv=1024)
TRAIN_DIR = Path(__file__).resolve().parent / "artifacts" / "train"
#: phase 18's device
CARD = "cuda"


def train_batch(cfg, b, s, rng, dev):
    """A train batch on ``dev``: uniform random tokens from ``rng`` and
    their shift as labels, with random stub ``src_embeds`` for the
    encoder-decoder."""
    tokens = rng.integers(0, cfg.vocab_size, (b, s + 1)).astype(np.int32)
    batch = {"tokens": tokens[:, :-1], "labels": tokens[:, 1:]}
    if cfg.family == "encdec":
        batch["src_embeds"] = rng.standard_normal((b, s, cfg.d_model),
                                                  dtype=np.float32)
    return {k: torch.as_tensor(np.ascontiguousarray(v), device=dev)
            for k, v in batch.items()}


def flash_backward_at_length(smi):
    """Flash's memory-exact backward against autograd through the plain
    forward at seq 4096 (float32), with both peaks and times."""
    from repro_torch.models import flash
    f = FLASH_LONG
    gen = torch.Generator(CARD).manual_seed(0)
    shape = (f["b"], f["s"], f["h"], f["hd"])
    q, k, v, do = (torch.randn(shape, device=CARD, generator=gen)
                   for _ in range(4))
    out = {}
    for name, fn in (("flash", flash.flash_attention),
                     ("naive", flash.flash_attention_naive_grad)):
        xs = [x.clone().requires_grad_(True) for x in (q, k, v)]
        run = lambda: torch.autograd.grad(
            (fn(*xs, causal=True, chunk_q=f["cq"], chunk_kv=f["ckv"])
             * do).sum(), xs)
        run()
        base = fresh_peak()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        g = run()
        torch.cuda.synchronize()
        out[name] = (g, (time.perf_counter() - t0) * 1e3,
                     torch.cuda.max_memory_allocated() / 2**30 - base)
    (gf, ms_f, peak_f), (gn, ms_n, peak_n) = out["flash"], out["naive"]
    err = max(float((a - b).abs().max() / b.abs().max())
              for a, b in zip(gf, gn))
    log("train", f"flash backward at length (causal, b {f['b']}, "
        f"{f['h']} heads, hd {f['hd']}, seq {f['s']}, chunks {f['cq']} / "
        f"{f['ckv']}, float32; {smi}): dq/dk/dv max |d| {err:.3e} of max|g| "
        f"(tol 1e-5) against autograd through the plain forward; forward + "
        f"backward {ms_f:.1f} ms, peak {peak_f:.3f} GiB above the inputs; "
        f"naive gradient {ms_n:.1f} ms, peak {peak_n:.3f} GiB")
    if err > 1e-5:
        raise AssertionError(f"flash backward at length: {err:.3e}")


def train_resume(smi):
    """``launch.train``'s entry point at full width for 30 steps with a
    checkpoint (on its default 1-rank mesh); then the loop resumes it to
    40 and runs an uninterrupted 40 on a 1-rank mesh too, with the
    launcher's optimizer for ``--steps 30`` (its schedule is tied to
    ``--steps``), the two step-40 states held to the reference test's
    contract, in deterministic mode."""
    import shutil
    from repro_torch.configs import get_config
    from repro_torch.launch import dryrun
    from repro_torch.launch import train as launch_train
    from repro_torch.models.registry import make_arch
    from repro_torch.parallel.mesh import make_host_mesh
    from repro_torch.train import optim
    from repro_torch.train.data import SyntheticLM
    from repro_torch.train.loop import train
    from repro_torch.tree import flatten
    d = TRAIN_DIR / "resume"
    shutil.rmtree(d, ignore_errors=True)
    t0 = time.perf_counter()
    h30 = deterministic(lambda: launch_train.main(
        ["--arch", "qwen1.5-0.5b", "--batch", "8", "--seq-len", "64",
         "--steps", "30", "--ckpt-dir", str(d), "--ckpt-every", "30",
         "--device", CARD]))
    t1 = time.perf_counter()
    cfg = get_config("qwen1.5-0.5b")
    arch = make_arch(cfg)
    opt = optim.adamw(optim.warmup_cosine(1e-3, max(30 // 20, 5), 30))
    data = SyntheticLM(cfg.vocab_size, 8, 64, seed=0)
    # the launcher trains on a 1-rank mesh: the loop resumes on one too
    with dryrun.one_rank_group(torch.device(CARD)):
        mesh = make_host_mesh(1, 1, device=CARD)
        resumed, h40 = deterministic(lambda: train(
            arch, opt, mesh, data, steps=40, ckpt_dir=str(d),
            ckpt_every=100))
        t2 = time.perf_counter()
        full, hfull = deterministic(lambda: train(arch, opt, mesh, data,
                                                  steps=40))
        t3 = time.perf_counter()
    pairs = list(zip(flatten(resumed)[1], flatten(full)[1]))
    bitwise = all(torch.equal(a, b) for a, b in pairs)
    worst = max(float((a.float() - b.float()).abs().sub(
        2e-4 * b.float().abs()).max()) for a, b in pairs)
    log("train", f"launch.train qwen1.5-0.5b full width, 8 x 64 tokens a "
        f"step ({smi}): 30 steps {t1 - t0:.1f} s with a checkpoint "
        f"({30 * 512 / (t1 - t0):.0f} tok/s; losses {h30}); the loop "
        f"resumed to 40 {t2 - t1:.1f} s with a restore and a checkpoint "
        f"(losses {h40}), uninterrupted 40 {t3 - t2:.1f} s "
        f"({40 * 512 / (t3 - t2):.0f} tok/s; losses {hfull}); step-40 "
        f"state resumed vs "
        f"uninterrupted: max(|d| - 2e-4 |b|) {worst:.3e} (atol 2e-5), "
        f"bitwise in deterministic mode {bitwise}; disk free "
        f"{shutil.disk_usage(TRAIN_DIR).free / 1e9:.0f} GB")
    if worst > 2e-5 or not hfull[-1] < hfull[0] or \
            abs(h40[-1] - hfull[-1]) > 2e-4 * abs(hfull[-1]):
        raise AssertionError(f"train resume: {worst}, {h40}, {hfull}")
    shutil.rmtree(d, ignore_errors=True)


def train_arm(smi):
    """qwen1.5-0.5b, bf16 compute, AdamW, 8 x 2048: ms per step, tok/s,
    peak memory beside the model-flops bound, one profiled step."""
    from repro_torch.analysis import flops, roofline
    from repro_torch.configs import get_config
    from repro_torch.models import transformer
    from repro_torch.models.registry import make_arch
    from repro_torch.train import optim
    from repro_torch.train.step import init_state, make_train_step
    cfg = get_config("qwen1.5-0.5b")
    b, s = TRAIN_ARM["batch"], TRAIN_ARM["seq"]
    arch = make_arch(cfg)
    opt = optim.adamw(optim.warmup_cosine(1e-3, 5, 300))
    state = init_state(arch, opt, seed=0, device=CARD)
    step = make_train_step(arch, opt)
    rng = np.random.default_rng(0)
    batches = [train_batch(cfg, b, s, rng, CARD) for _ in range(4)]
    state, m = step(state, batches[0])                    # warm-up
    base = fresh_peak()
    ms = []
    for batch in batches[1:]:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step(state, batch)
        float(m["loss"])
        ms.append((time.perf_counter() - t0) * 1e3)
    peak = torch.cuda.max_memory_allocated() / 2**30
    med = sorted(ms)[1]
    fwd = flops.fwd_flops(cfg, b * s, s)
    bound = 3 * fwd / roofline.PEAK_FLOPS_BF16 * 1e3
    log("train", f"timed arm qwen1.5-0.5b full width, {cfg.dtype} compute, "
        f"AdamW, {b} x {s} = {b * s} tokens a step ({smi}): ms per step "
        f"{[round(x, 1) for x in ms]} (median {med:.1f}), "
        f"{b * s / med * 1e3:.0f} tok/s, loss {float(m['loss']):.4f}; "
        f"peak {peak:.2f} GiB (held before: {base:.2f}; params "
        f"{transformer.param_bytes(state['params']) / 2**30:.2f} GiB f32)")
    log("train", f"model flops of a step: 3 x forward = {3 * fwd:.4e} "
        f"(useful; step_flops charges 5 x = {5 * fwd:.4e} with remat); "
        f"bf16 bound {bound:.1f} ms at {roofline.PEAK_FLOPS_BF16 / 1e12:.0f}"
        f" TFLOP/s -> {bound / med * 100:.1f} % of peak; 5 x at the bound "
        f"{5 * fwd / roofline.PEAK_FLOPS_BF16 * 1e3:.1f} ms")
    wall, per = profiled(lambda: step(state, batches[1]))
    log_breakdown("train", "train step", wall * 1e6, per, top=10)
    del state, batches


def train_full_configs(smi):
    """One train step of every other LM config whose f32 AdamW state fits
    the card, at full width; the rest reckoned on the meta device; the
    encoder-decoder also served whole."""
    import gc
    from repro_torch.configs import LM_ARCH_IDS, get_config
    from repro_torch.models import transformer
    from repro_torch.models.registry import make_arch
    from repro_torch.train import optim
    from repro_torch.train.step import init_state, make_train_step
    budget = torch.cuda.mem_get_info()[1]
    for arch_id in LM_ARCH_IDS:
        if arch_id in TRAIN_FULL + ("qwen1.5-0.5b",):
            continue
        n = transformer.param_count(make_arch(get_config(arch_id)).init(
            torch.Generator(), device="meta"))
        log("train", f"{arch_id}: not trained: its f32 params, grads and "
            f"AdamW moments reckon {16 * n / 1e9:.1f} GB ({n / 1e9:.2f} B "
            f"params) of the card's {budget / 1e9:.1f} GB")
    b, s = TRAIN_FULL_SHAPE["batch"], TRAIN_FULL_SHAPE["seq"]
    rng = np.random.default_rng(1)
    for arch_id in TRAIN_FULL:
        cfg = get_config(arch_id)
        arch = make_arch(cfg)
        opt = optim.adamw(optim.warmup_cosine(1e-3, 5, 300))
        base = fresh_peak()
        t0 = time.perf_counter()
        state = init_state(arch, opt, seed=0, device=CARD)
        batch = train_batch(cfg, b, s, rng, CARD)
        state, m = make_train_step(arch, opt)(state, batch)
        loss = float(m["loss"])
        wall = time.perf_counter() - t0
        n = transformer.param_count(state["params"])
        log("train", f"{arch_id} full ({cfg.family}, {cfg.n_layers} layers, "
            f"d_model {cfg.d_model}, {cfg.dtype} compute, {n / 1e9:.2f} B "
            f"params; {smi}): init + one AdamW step of {b} x {s} tokens "
            f"{wall:.2f} s, loss {loss:.4f}, grad_norm "
            f"{float(m['grad_norm']):.3f}; peak "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB (held "
            f"before: {base:.2f}; reckoned state {16 * n / 2**30:.2f} GiB)")
        if not math.isfinite(loss):
            raise AssertionError(f"train {arch_id}: loss {loss}")
        if cfg.family == "encdec":
            serve_encdec(arch, state["params"], rng, smi)
        del state, batch, m
        gc.collect()
        torch.cuda.empty_cache()


def serve_encdec(arch, params, rng, smi, n_new=8):
    """The encoder-decoder served whole: a prefill over random
    ``src_embeds`` and ``n_new`` greedy decode steps, twice."""
    cfg = arch.cfg
    src = torch.as_tensor(rng.standard_normal((2, 64, cfg.d_model),
                                              dtype=np.float32),
                          device=CARD)
    prompt = torch.as_tensor(np.stack([np.arange(9)] * 2) % cfg.vocab_size,
                             device=CARD).to(torch.int32)
    runs = []
    with torch.inference_mode():
        for _ in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            last, caches = arch.prefill(params, {"src_embeds": src,
                                                 "tokens": prompt},
                                        prompt.shape[1] + n_new)
            tok = torch.argmax(last[:, -1], -1)
            out, finite = [tok.tolist()], bool(torch.isfinite(last).all())
            for j in range(n_new - 1):
                logits, caches = arch.decode_step(
                    params, {"tokens": tok[:, None].to(torch.int32)},
                    caches, prompt.shape[1] + j)
                finite &= bool(torch.isfinite(logits).all())
                tok = torch.argmax(logits[:, -1], -1)
                out.append(tok.tolist())
            runs.append(out)
            wall = time.perf_counter() - t0
    log("train", f"{cfg.name} served whole ({smi}): 2 x 64 source frames, "
        f"a 9-token prompt, {n_new} greedy tokens in {wall:.3f} s; finite "
        f"{finite}; greedy runs equal {runs[0] == runs[1]}; tokens "
        f"{[list(t) for t in zip(*runs[0])]}")
    if not finite or runs[0] != runs[1]:
        raise AssertionError(f"serve {cfg.name}: {runs}")


def phase_train(smi):
    """Phase 18: the LM training path on the card -- the full-width
    fixture hold, flash's backward at length, ``launch.train`` with a
    resume, the timed arm, the full configs, no kernel launched."""
    import gc
    sys.path.insert(0, str(Path(__file__).resolve().parent / "tests"))
    import lm_fixture
    import lm_train_fixture as ltf
    t_phase = time.perf_counter()
    # -- the main path: counts to 0 just before, read just after ----------
    torch.cuda.synchronize()
    zero_counts()
    t0 = time.perf_counter()
    tree = lm_fixture.param_tree(lm_fixture.config("float32"))
    log("train", f"fixture weights (numpy seed {lm_fixture.SEED}) built in "
        f"{time.perf_counter() - t0:.1f} s")
    for dtype in ltf.DTYPES:
        t0 = time.perf_counter()
        r = ltf.check(torch.device(CARD), dtype, tree)
        held = (f"gradient probes max |d| {r['grad_max_err']:.3e} of max|g| "
                f"(tol {ltf.GRAD_TOL}), per-leaf float64 norms within "
                f"{max(r['grad_leaf_norm_rel_err']):.2e}; grad_norm "
                f"{r['grad_norm']} within "
                f"{r['grad_norm_max_rel_err']:.2e} of the reference "
                f"gradient's float64 norm (tol {ltf.GNORM_RTOL}; the "
                f"reference's own float32 metric sits "
                f"{r['ref_metric_vs_norm64_rel']:.2e} from it)")
        if dtype == "float32":
            held += (f", params after {ltf.STEPS} steps: {r['flips']} sign "
                     f"flips ({r['flip_share']:.2e} of the probes, under "
                     f"{ltf.FLIP_SHARE}; largest {r['param_max_err']:.3e}, "
                     f"largest off flips {r['param_max_err_off_flips']:.3e}"
                     f", flips' max |g| {r['flip_max_abs_grad']:.3e})")
        else:
            held += (f" (printed, not held), params beyond 1e-6: "
                     f"{r['param_share_over_atol']:.2e} of the probes")
        log("train", f"qwen1.5-0.5b full width, {dtype} compute, {ltf.STEPS}"
            f" AdamW steps of {ltf.BATCH} x {ltf.SEQ} held to the "
            f"reference's fixture ({smi}): losses {r['loss']} vs "
            f"{r['want_loss']}, max |d| {r['loss_max_abs_err']:.3e} (rel "
            f"{r['loss_max_rel_err']:.2e}); {held}; "
            f"{time.perf_counter() - t0:.1f} s")
    del tree
    gc.collect()
    torch.cuda.empty_cache()
    flash_backward_at_length(smi)
    train_resume(smi)
    train_arm(smi)
    gc.collect()
    torch.cuda.empty_cache()
    train_full_configs(smi)
    no_launches("train", "the LM training path has no hand-written kernel")
    log("train", f"phase 18 in {time.perf_counter() - t_phase:.1f} s")


def _losses_and_ms(fn):
    """``(fn()'s result, ms per logged step)``: the loop's CSV captured
    (and echoed), each step's ms from its ``tokens_per_s`` column."""
    import contextlib
    import io
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn()
    rows = [l.split(",") for l in buf.getvalue().splitlines()
            if l[:1].isdigit()]
    return out, rows


#: phases 19-20's SSM and hybrid configs at full width, float32 compute
#: (hf:tiiuae/falcon-mamba-7b, hf:Zyphra/Zamba2-1.2B; nothing cut): served
#: on (1, 2) with 2 slots, ``max_len`` 64, the reference test's prompt
#: lengths and 8 new tokens; zamba2 trained 2 SGD steps of 2 x 128
MESH_SSM = ("falcon-mamba-7b", "zamba2-1.2b")
MESH_SSM_SERVE = dict(slots=2, max_len=64, prompts=(5, 9), new=8)
MESH_HYBRID_TRAIN = dict(arch="zamba2-1.2b", batch=2, seq=128, steps=2)
#: the bound on zamba2's step-1 gradient on (1, 2) against the 1-rank run,
#: each leaf's norm and the global norm: on the CPU at d_model 512 and the
#: full 38 layers, float32 (``tests/survey_mesh_ssm.py grads``), the
#: reference's own (1, 2) and (1, 1) gradients part by up to 4.86e-05 in a
#: leaf's norm (3.72e-05 globally), the port's by 7.35e-05; on the card
#: every weight one ulp off moves the 1-rank gradient's leaf norms by up
#: to 1.08e-03 (4.25e-04 globally; PERF.md section 6, run 5, printed by
#: phase 19 beside the (1, 2) gaps); a gradient summed twice, or not
#: summed, moves a leaf's norm by 0.29 or more
HYBRID_GRAD_RTOL = 1e-3
#: phase 19's (1, 2) qwen step while the loss took the logits assembled
#: over ``model`` (PERF.md section 6, NVIDIA H100 80GB HBM3, 700.00 W)
ASSEMBLED_LOGITS_MESH_LM = {"all-reduces": 262, "MiB": 555.8}


def f32_config(arch_id):
    """The full config of ``arch_id`` with float32 compute."""
    import dataclasses
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config(arch_id), dtype="float32")


def ssm_prompts(cfg):
    return [np.arange(n) % cfg.vocab_size
            for n in MESH_SSM_SERVE["prompts"]]


def decode_collectives(cfg, slots):
    """``(all-reduces, wire bytes)`` of one decode step of an SSM or hybrid
    ``cfg`` computing tensor-parallel on a (1, 2) mesh, reckoned from the
    code: the vocab-parallel embedding's psum, per Mamba layer the psum of
    ``out_proj`` (Mamba-1: also of ``x_proj``'s r + 2n outputs), per
    shared attention block the attention's and the MLP's psums, and the
    logits' assembly -- each a float32 (slots, 1, width) all-reduce whose
    wire bytes on two ranks are its bytes."""
    per_layer = [cfg.d_model]
    if cfg.ssm_variant == "mamba1":
        per_layer.append(cfg.ssm_dt_rank + 2 * cfg.ssm_state)
    shared = (-(-cfg.n_layers // cfg.hybrid_attn_every)
              if cfg.family == "hybrid" else 0)
    widths = ([cfg.d_model] + per_layer * cfg.n_layers
              + [cfg.d_model] * 2 * shared + [cfg.vocab_size])
    return len(widths), 4 * slots * sum(widths)


def held_rel(got, want, parted):
    """The largest |d| of each step's logits over that step's largest
    |logit|, over the slots whose inputs still agree (up to the step at
    which a counted near tie parted them)."""
    first = {}
    for i, t in parted:
        first[i] = min(first.get(i, t), t)
    err = 0.0
    for t, (g, w) in enumerate(zip(got, want)):
        rows = [i for i in range(w.shape[0]) if first.get(i, t) >= t]
        if rows:
            err = max(err, float(np.abs(g[rows] - w[rows]).max()
                                 / np.abs(w[rows]).max()))
    return err


def hybrid_run(mesh, leaf_sq):
    """``(losses, final state)`` of :data:`MESH_HYBRID_TRAIN` through
    ``train.loop.train(mesh=)``: zamba2-1.2b at full width, seeded
    weights, float32 compute, :func:`hybrid_optimizer`, ``SyntheticLM``
    from seed 0; each step's :func:`grad_leaf_sq` appended to
    ``leaf_sq``."""
    from repro_torch.models.registry import make_arch
    from repro_torch.train.data import SyntheticLM
    from repro_torch.train.loop import train
    t = MESH_HYBRID_TRAIN
    cfg = f32_config(t["arch"])
    state, hist = train(make_arch(cfg), hybrid_optimizer(leaf_sq), mesh,
                        SyntheticLM(cfg.vocab_size, t["batch"], t["seq"],
                                    seed=0),
                        steps=t["steps"], log_every=1)
    return np.array(hist, np.float64), state


def hybrid_optimizer(leaf_sq=None):
    """SGD with momentum 0.9 and clipping at 1.0 over phase 19's schedule
    (``warmup_cosine(1e-3, 5, 300)``, ``tests/lm_train_fixture.LR``):
    after an SGD step the loss moves with the gradient, so a later step's
    loss holds it.  After AdamW's first step, sign-like and blind to each
    leaf's scale, zamba2's (1, 2) and 1-rank losses parted by 3.11e-04
    (PERF.md section 6).  With ``leaf_sq`` each update first appends
    :func:`grad_leaf_sq` of the gradient it is given."""
    import dataclasses
    import lm_train_fixture as ltf
    from repro_torch.train import optim
    opt = optim.sgdm(optim.warmup_cosine(*ltf.LR))
    if leaf_sq is None:
        return opt

    def update(grads, state, params, shards=None, inner=opt.update):
        leaf_sq.append(grad_leaf_sq(grads, shards))
        return inner(grads, state, params, shards=shards)
    return dataclasses.replace(opt, update=update)


def leaf_gaps(sq, want):
    """The relative gap of each leaf's norm (``{key: squared norm}``
    records, :func:`grad_leaf_sq`) to ``want``'s: per leaf, the worst and
    where, and of the global norm."""
    leaf = {k: abs(math.sqrt(sq[k] / want[k]) - 1) for k in want}
    at = max(leaf, key=leaf.get)
    return {"leaf": {k: float(f"{v:.2e}") for k, v in leaf.items()},
            "worst": leaf[at], "at": at,
            "global": abs(math.sqrt(sum(sq.values()) / sum(want.values()))
                          - 1)}


def hybrid_ulp_sq(mesh):
    """:func:`grad_leaf_sq` of the step-1 gradient of
    :data:`MESH_HYBRID_TRAIN` on ``mesh`` through ``train.step``'s sharded
    step, from the seeded weights each moved one ulp up or down (signs
    drawn from seed 1).  The activation shardings the step registers are
    cleared after it, as ``train.loop.train`` clears them: left
    registered, they make later unsharded models cast their layer weights
    to bfloat16 (``act_sharding.gather_layer_params``)."""
    from repro_torch.parallel import act_sharding
    try:
        return _hybrid_ulp_sq(mesh)
    finally:
        act_sharding.clear()


def _hybrid_ulp_sq(mesh):
    from repro_torch.models.registry import make_arch
    from repro_torch.train.data import SyntheticLM
    from repro_torch.train.step import init_state, jit_train_step
    from repro_torch.tree import flatten, unflatten
    t = MESH_HYBRID_TRAIN
    cfg = f32_config(t["arch"])
    arch, leaf_sq = make_arch(cfg), []
    opt = hybrid_optimizer(leaf_sq)
    batch = {k: torch.as_tensor(v, device=mesh.device) for k, v in
             SyntheticLM(cfg.vocab_size, t["batch"], t["seq"],
                         seed=0).batch_at(0).items()}
    fn = jit_train_step(arch, opt, mesh, {
        k: torch.empty(v.shape, dtype=v.dtype, device="meta")
        for k, v in batch.items()})[0]
    state = init_state(arch, opt, mesh, 0)
    gen = torch.Generator(mesh.device).manual_seed(1)
    leaves = flatten(state["params"])[1]
    state["params"] = unflatten(state["params"], [
        torch.nextafter(x, torch.where(
            torch.rand(x.shape, generator=gen, device=x.device) < 0.5,
            -math.inf, math.inf).to(x.dtype)) for x in leaves])
    fn(state, batch)
    return leaf_sq[0]


def grad_leaf_sq(grads, shards):
    """``{key: squared norm}`` of this rank's block of each gradient leaf
    over the count of the leaf's replicas (``zero.Layout.replicas``), so
    that the ranks' records add up to the whole leaf's; no collective."""
    from repro_torch.tree import flatten
    keys, leaves = flatten(grads)
    reps = ([1] * len(leaves) if shards is None
            else [lay.replicas() for lay in shards.layouts])
    norms = torch.stack([torch.linalg.vector_norm(x.float())
                         for x in leaves]).double().square().tolist()
    return {k: n / r for k, n, r in zip(keys, norms, reps)}


def mesh_lm_rank(job):
    """One rank of phase 19's gloo runs: qwen1.5-0.5b at full width on the
    seeded weights in float32 on each mesh of ``job["shapes"]`` (all the
    ranks), through ``train.loop.train(mesh=)``; with ``job["hybrid"]``
    then :data:`MESH_HYBRID_TRAIN` on (1, 2)."""
    import gc
    import torch.distributed as tdist
    sys.path.insert(0, str(Path(__file__).resolve().parent / "tests"))
    import lm_fixture
    import lm_mesh_fixture as lmf
    import lm_train_fixture as ltf
    from repro_torch.core import distributed as D
    from repro_torch.parallel import sharding as shd
    from repro_torch.train.step import state_specs
    zero_counts()
    cfg = lm_fixture.config("float32")
    tree = lm_fixture.param_tree(cfg)
    tokens = ltf.BATCH * ltf.SEQ
    out = []
    for shape in job["shapes"]:
        mesh = D.make_mesh(shape, ("data", "model"), "cuda")
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        with D.count_collectives() as c:
            t0 = time.perf_counter()
            (losses, state), rows = _losses_and_ms(
                lambda: lmf.run(cfg, tree, mesh))
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        shapes, specs = state_specs(lmf.seeded_arch(cfg, tree),
                                    ltf.optimizer(), mesh)
        out.append({"arch": "qwen1.5-0.5b", "shape": tuple(shape),
                    "rank": tdist.get_rank(),
                    "coord": dict(mesh.coord), "losses": losses.tolist(),
                    "peak": torch.cuda.max_memory_allocated(),
                    "held": torch.cuda.memory_allocated(),
                    "reckoned": shd.per_device_bytes(shapes, specs, mesh),
                    "counts": dict(c.counts), "wire": c.total_wire_bytes,
                    "ms": [tokens / float(r[5]) * 1e3 for r in rows],
                    "wall": wall, "launches": launch_counts()})
        del state
    if job.get("hybrid"):
        from repro_torch.models.registry import make_arch
        t = MESH_HYBRID_TRAIN
        mesh = D.make_mesh((1, 2), ("data", "model"), "cuda")
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        leaf_sq = []
        with D.count_collectives() as c:
            t0 = time.perf_counter()
            (losses, state), rows = _losses_and_ms(
                lambda: hybrid_run(mesh, leaf_sq))
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        shapes, specs = state_specs(make_arch(f32_config(t["arch"])),
                                    hybrid_optimizer(), mesh)
        out.append({"arch": t["arch"], "shape": (1, 2),
                    "rank": tdist.get_rank(), "coord": dict(mesh.coord),
                    "losses": losses.tolist(),
                    "peak": torch.cuda.max_memory_allocated(),
                    "held": torch.cuda.memory_allocated(),
                    "reckoned": shd.per_device_bytes(shapes, specs, mesh),
                    "counts": dict(c.counts), "wire": c.total_wire_bytes,
                    "ms": [t["batch"] * t["seq"] / float(r[5]) * 1e3
                           for r in rows],
                    "grad_norm": [r[3] for r in rows],
                    "leaf_sq": leaf_sq[0],
                    "wall": wall, "launches": launch_counts(),
                    "in_proj": tuple(state["params"]["layers"]["ssm"]
                                     ["in_proj"].shape)})
        del state
    return out


MESH_JOBS["lm_mesh"] = mesh_lm_rank


def mesh_lm_dryrun(smi):
    """``launch.dryrun --arch qwen1.5-0.5b --all --both-meshes``: each
    cell's reckoned GiB per device and analytic flops, and whether its
    one-device reckoning fits the card."""
    from repro_torch.launch import dryrun
    out_dir = Path(__file__).resolve().parent / "artifacts" / "dryrun"
    total = torch.cuda.get_device_properties(0).total_memory
    t0 = time.perf_counter()
    dryrun.main(["--arch", "qwen1.5-0.5b", "--all", "--both-meshes",
                 "--out", str(out_dir), "--force"])
    fits = []
    for mesh_name in ("pod", "multipod"):
        for path in sorted((out_dir / mesh_name / "qwen1.5-0.5b").glob(
                "*.json")):
            art = json.loads(path.read_text())
            if art.get("skipped"):
                log("mesh_lm", f"{mesh_name}/{path.stem}: skipped "
                    f"({art['reason'][:40]})")
                continue
            per = art["reckoned_bytes_per_device"]
            one = art["reckoned_bytes_one_device"]
            fits.append((path.stem, one["total"] <= total))
            log("mesh_lm", f"{mesh_name}/{path.stem} ({art['strategy']}"
                f", {art['n_devices']} devices): reckoned "
                f"{per['total'] / 2**30:.4f} GiB/device "
                f"({', '.join(f'{k} {v / 2**30:.4f}' for k, v in per.items() if k != 'total')}); "
                f"analytic flops {art['analytic_flops']:.4e} "
                f"(fwd {art['analytic_flops_fwd']:.4e}), model flops "
                f"{art['model_flops']:.4e}, analytic bytes "
                f"{art['analytic_bytes']:.4e}; on one device "
                f"{one['total'] / 2**30:.2f} GiB reckoned against the "
                f"card's {total / 2**30:.2f} GiB ({smi}): "
                f"{'fits' if one['total'] <= total else 'does not fit'}")
    log("mesh_lm", f"dry-run of the qwen1.5-0.5b cells in "
        f"{time.perf_counter() - t0:.1f} s; cells whose one-device "
        f"reckoning fits the card: {[n for n, ok in fits if ok] or 'none'}")


#: phase 19's gloo runs while the model axis sharded storage only, before
#: it computed tensor-parallel (PERF.md section 6, NVIDIA H100 80GB HBM3,
#: 700.00 W): all-reduces and MiB per step, peak per rank
STORAGE_ONLY_MESH_LM = {
    (2, 1): "778 all-reduces, 5241.0 MiB per step, peak 11.17 GiB",
    (1, 2): "693 all-reduces, 2877.9 MiB per step, peak 11.17 GiB"}


def phase_mesh_lm(smi):
    """Phase 19: the LM meshes -- ZeRO-3 training through
    ``train.loop.train(mesh=)`` on a 1-rank NCCL mesh held to the
    reference's sharded fixture, 2 gloo ranks sharing the card ((1, 2)
    computing tensor-parallel on ``model``, the loss vocab-parallel),
    zamba2-1.2b at full width on (1, 2) held to its 1-rank run, the LM
    dry-run over the named meshes; no kernel launched."""
    import gc
    sys.path.insert(0, str(Path(__file__).resolve().parent / "tests"))
    import lm_fixture
    import lm_mesh_fixture as lmf
    from repro_torch.launch import dryrun
    from repro_torch.parallel.mesh import make_host_mesh
    from repro_torch.tree import flatten
    t_phase = time.perf_counter()
    # -- the main path: counts to 0 just before, read just after ----------
    torch.cuda.synchronize()
    zero_counts()
    t0 = time.perf_counter()
    tree = lm_fixture.param_tree(lm_fixture.config("float32"))
    lmf.check_weights(tree)
    log("mesh_lm", f"fixture weights built in {time.perf_counter() - t0:.1f}"
        f" s")
    runs = {}
    with dryrun.one_rank_group(torch.device(CARD)):
        mesh = make_host_mesh(1, 1, device=CARD)
        for dtype in lmf.DTYPES:
            cfg = lm_fixture.config(dtype)
            fresh_peak()
            t0 = time.perf_counter()
            (losses, state), rows = _losses_and_ms(lambda: deterministic(
                lambda: lmf.run(cfg, tree, mesh)))
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            r = lmf.hold(losses, dtype)
            runs[dtype] = (losses, state)
            log("mesh_lm", f"qwen1.5-0.5b full width on a 1-rank NCCL "
                f"(1, 1) mesh, {dtype} compute, {lmf.STEPS} AdamW steps of "
                f"2 x 128 through train(mesh=) ({smi}): losses {r['loss']} "
                f"vs the reference's sharded {r['want_loss']}, max |d| "
                f"{r['loss_max_abs_err']:.3e} (rel "
                f"{r['loss_max_rel_err']:.2e}); lr and grad_norm per step "
                f"{[(row[4], row[3]) for row in rows]}; ms per step "
                f"{[round(2 * 128 / float(row[5]) * 1e3, 1) for row in rows]}"
                f"; peak {torch.cuda.max_memory_allocated() / 2**30:.2f} "
                f"GiB; {wall:.1f} s")
    # on bfloat16 compute the cast reaches the matmuls' weights as a no-op;
    # the float32 norm scales and every cast leaf's gradient are rounded
    cfg = lm_fixture.config("bfloat16")
    plain, pstate = deterministic(lambda: lmf.run(cfg, tree, None,
                                                  device=CARD))
    sharded, sstate = runs["bfloat16"]
    same_first = plain[:1].tobytes() == sharded[:1].tobytes()
    same = (plain.tobytes() == sharded.tobytes() and all(
        torch.equal(a, b) for a, b in zip(flatten(sstate)[1],
                                          flatten(pstate)[1])))
    log("mesh_lm", f"bfloat16, deterministic mode: the 1-rank sharded run "
        f"vs the port's unsharded run: step-1 loss bit for bit "
        f"{same_first}; the whole run (losses and every state leaf) bit for "
        f"bit {same}; unsharded losses {plain.tolist()}, sharded "
        f"{sharded.tolist()}")
    f32 = runs["float32"][0]
    del runs, sstate, pstate, state, tree
    gc.collect()
    torch.cuda.empty_cache()
    # -- zamba2-1.2b at full width on a 1-rank NCCL mesh ------------------
    t = MESH_HYBRID_TRAIN
    with dryrun.one_rank_group(torch.device(CARD)):
        base = fresh_peak()
        t0 = time.perf_counter()
        one_sq = []
        (hybrid, state), rows = _losses_and_ms(lambda: hybrid_run(
            make_host_mesh(1, 1, device=CARD), one_sq))
        torch.cuda.synchronize()
        log("mesh_lm", f"{t['arch']} full width (float32 compute) on a "
            f"1-rank NCCL (1, 1) mesh, {t['steps']} SGD steps of "
            f"{t['batch']} x {t['seq']} through train(mesh=) ({smi}): "
            f"losses {hybrid.tolist()}; grad_norm per step "
            f"{[row[3] for row in rows]}; ms per step "
            f"{[round(t['batch'] * t['seq'] / float(r[5]) * 1e3, 1) for r in rows]}"
            f"; peak {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB "
            f"(held before {base:.2f}); "
            f"{time.perf_counter() - t0:.1f} s")
        hybrid_norms = [row[3] for row in rows]
        one_sq = one_sq[0]
        if not np.isfinite(hybrid).all():
            raise AssertionError(f"mesh_lm {t['arch']}: {hybrid}")
        del state
        gc.collect()
        torch.cuda.empty_cache()
        # how far rounding-level changes move this gradient on its own
        # (no tensor parallelism): every weight one ulp off
        t0 = time.perf_counter()
        ulp = leaf_gaps(hybrid_ulp_sq(make_host_mesh(1, 1, device=CARD)),
                        one_sq)
        log("mesh_lm", f"{t['arch']} on the 1-rank mesh, every weight one "
            f"ulp off (seeded signs): step-1 gradient, each leaf's norm "
            f"rel to the unmoved run's at most {ulp['worst']:.2e} "
            f"({ulp['at']}), the global norm {ulp['global']:.2e}; per "
            f"leaf {ulp['leaf']}; {time.perf_counter() - t0:.1f} s")
    gc.collect()
    torch.cuda.empty_cache()
    # -- 2 gloo ranks sharing the card ------------------------------------
    t0 = time.perf_counter()
    outs = spawn_ranks(2, "gloo", [{"name": "lm_mesh",
                                    "shapes": [(2, 1), (1, 2)],
                                    "hybrid": True}])
    hybrid_sq = {}
    for rank_out in outs:
        for r in rank_out[0]:
            for k, v in r.get("leaf_sq", {}).items():
                hybrid_sq[k] = hybrid_sq.get(k, 0.0) + v
    for rank_out in outs:
        for r in rank_out[0]:
            qwen = r["arch"] == "qwen1.5-0.5b"
            steps = lmf.STEPS if qwen else t["steps"]
            want = f32 if qwen else hybrid
            err = float(np.abs(np.array(r["losses"]) / want - 1).max())
            mib = r["wire"] / steps / 2**20
            beside = (f"the storage-only model axis's "
                      f"{STORAGE_ONLY_MESH_LM[tuple(r['shape'])]}"
                      if qwen else f"in_proj block {r['in_proj']}; "
                      f"grad_norm per step {r['grad_norm']}")
            if qwen and tuple(r["shape"]) == (1, 2):
                beside += (f"; with the logits assembled "
                           f"{ASSEMBLED_LOGITS_MESH_LM['all-reduces']} "
                           f"all-reduces, {ASSEMBLED_LOGITS_MESH_LM['MiB']} "
                           f"MiB per step")
            log("mesh_lm", f"gloo {r['shape']} rank {r['rank']} "
                f"{r['coord']} {r['arch']} float32 ({smi}): losses "
                f"{r['losses']} (rel to the 1-rank run {err:.2e}); peak "
                f"{r['peak'] / 2**30:.3f} GiB beside the reckoned per-rank "
                f"state {r['reckoned'] / 2**30:.3f} GiB (held after "
                f"{r['held'] / 2**30:.3f} GiB); collectives per step "
                f"{ {k: v / steps for k, v in r['counts'].items()} }, "
                f"wire {mib:.3f} MiB per step; "
                f"ms per step {[round(x, 1) for x in r['ms']]} (ranks share "
                f"the card: a record); launches {r['launches']}; beside "
                f"{beside}")
            if err > 1e-5 or any(r["launches"].values()):
                raise AssertionError(f"mesh_lm gloo {r['shape']}: {r}")
            if qwen and tuple(r["shape"]) == (1, 2) and \
                    mib >= ASSEMBLED_LOGITS_MESH_LM["MiB"]:
                raise AssertionError(f"mesh_lm (1, 2): {mib} MiB a step "
                                     f"still assembles the logits")
    # zamba2's step-1 gradient on (1, 2), leaf by leaf: each whole leaf's
    # norm (the ranks' records added) against the 1-rank run's, and the
    # global norm
    tp_gap = leaf_gaps(hybrid_sq, one_sq)
    log("mesh_lm", f"gloo (1, 2) {t['arch']} ({smi}): step-1 gradient, "
        f"each leaf's norm rel to the 1-rank run's at most "
        f"{tp_gap['worst']:.2e} ({tp_gap['at']}), the global norm "
        f"{math.sqrt(sum(hybrid_sq.values())):.6f} beside "
        f"{math.sqrt(sum(one_sq.values())):.6f} (rel "
        f"{tp_gap['global']:.2e}); tol {HYBRID_GRAD_RTOL:.0e}; per leaf "
        f"{tp_gap['leaf']}; beside the one-ulp move's "
        f"{ulp['worst']:.2e} / {ulp['global']:.2e}")
    if max(tp_gap["worst"], tp_gap["global"]) > HYBRID_GRAD_RTOL:
        raise AssertionError(f"mesh_lm gloo (1, 2) {t['arch']}: step-1 "
                             f"gradient {tp_gap}")
    log("mesh_lm", f"gloo ranks in {time.perf_counter() - t0:.1f} s")
    mesh_lm_dryrun(smi)
    no_launches("mesh_lm", "the LM mesh path has no hand-written kernel")
    log("mesh_lm", f"phase 19 in {time.perf_counter() - t_phase:.1f} s")


#: phase 20's runs: granite-moe-1b-a400m at full width and reduced yi-6b's
#: long cache (prompts of these lengths, 8 new tokens, 2 slots)
SERVE_MESH_YI = dict(max_len=8192, prompts=(6000, 5000), new=8)


def serve_mesh_run(eng, prompts, max_new):
    """One ``ServeEngine.run`` over ``prompts``: tokens per request, the
    (B, V) float32 logits every sampling step saw, and per prefill and per
    decode step its synchronised ms and the all-reduce calls and wire
    bytes it made (the model's; the engine's assembly of the logits over
    the batch axes comes after)."""
    import dataclasses
    from repro_torch.core import distributed as D
    steps, rec = [], {"prefill": [], "decode": []}
    sample, arch = eng._sample, eng.arch

    def record(logits):
        steps.append(logits[:, -1].float().cpu().numpy())
        return sample(logits)

    def timed(kind, fn):
        def call(*a):
            torch.cuda.synchronize()
            before = D.collective_stats()
            t0 = time.perf_counter()
            out = fn(*a)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            after = D.collective_stats()
            rec[kind].append((ms, after.counts.get("all-reduce", 0)
                              - before.counts.get("all-reduce", 0),
                              after.total_wire_bytes
                              - before.total_wire_bytes))
            return out
        return call

    eng._sample = record
    eng.arch = dataclasses.replace(
        arch, prefill=timed("prefill", arch.prefill),
        decode_step=timed("decode", arch.decode_step))
    try:
        reqs = [eng.submit(p, max_new_tokens=max_new) for p in prompts]
        out = eng.run()
    finally:
        eng._sample, eng.arch = sample, arch
    return [out["results"][r.rid] for r in reqs], steps, rec


def serve_mesh_line(rec):
    """The per-call numbers of :func:`serve_mesh_run` as text: ms per
    prefill and per decode step (steps after the first), all-reduces and
    MiB per decode step."""
    pre = [r[0] for r in rec["prefill"]]
    dec = rec["decode"]
    warm = dec[1:] or dec
    return (f"ms per prefill {[round(x, 1) for x in pre]}, per decode step "
            f"{np.median([r[0] for r in warm]):.2f} (median of "
            f"{len(warm)}); per decode step {dec[0][1] if dec else 0} "
            f"all-reduces, {dec[0][2] / 2**20 if dec else 0:.3f} MiB on "
            f"the wire; per prefill {rec['prefill'][0][1]} all-reduces, "
            f"{rec['prefill'][0][2] / 2**20:.3f} MiB")


def reckoned_serve_bytes(eng):
    """Bytes one rank holds of the engine's params and of its caches, laid
    out by the rules (``parallel.sharding.per_device_bytes``)."""
    from repro_torch.parallel import sharding as shd
    arch, mesh = eng.arch, eng.mesh
    params = arch.init(torch.Generator(), device="meta")
    caches = arch.init_cache(eng.B, eng.S, device="meta")
    return (shd.per_device_bytes(params, eng._spec_tree, mesh)
            + shd.per_device_bytes(caches, eng.cache_specs, mesh))


def mesh_serve_rank(job):
    """One rank of phase 20's gloo runs on a (1, 2) mesh sharing the card:
    qwen1.5-0.5b at full width on the fixture's weights in float32; then
    granite-moe-1b-a400m at full width and reduced yi-6b at ``max_len``
    8192, each beside the port's unsharded engine of the same seed."""
    import dataclasses
    import gc
    import torch.distributed as tdist
    sys.path.insert(0, str(Path(__file__).resolve().parent / "tests"))
    import lm_fixture
    from repro_torch.configs import get_config
    from repro_torch.core import distributed as D
    from repro_torch.models.registry import make_arch
    from repro_torch.serve.engine import ServeEngine
    zero_counts()
    mesh = D.make_mesh((1, 2), ("data", "model"), "cuda")
    out = {"rank": tdist.get_rank(), "coord": dict(mesh.coord)}

    def fresh():
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()

    cfg = lm_fixture.config("float32")
    fresh()
    eng = ServeEngine(make_arch(cfg), mesh, batch_slots=lm_fixture.SLOTS,
                      max_len=lm_fixture.MAX_LEN)
    eng.load_params(lm_fixture.param_tree(cfg))
    tokens, steps, rec = serve_mesh_run(eng, lm_fixture.prompts(cfg),
                                        lm_fixture.MAX_NEW)
    out["qwen"] = {"tokens": tokens, "steps": steps, "rec": rec,
                   "peak": torch.cuda.max_memory_allocated(),
                   "reckoned": reckoned_serve_bytes(eng),
                   "wq": tuple(eng.params["layers"]["attn"]["wq"].shape)}
    del eng
    runs = (("granite", dataclasses.replace(
        get_config("granite-moe-1b-a400m"), dtype="float32"), 2, 64,
        [np.arange(n) % 49155 for n in (5, 9)], 8),
        ("yi", get_config("yi-6b", reduced=True), 2,
         SERVE_MESH_YI["max_len"],
         [np.random.default_rng(n).integers(0, 512, n)
          for n in SERVE_MESH_YI["prompts"]], SERVE_MESH_YI["new"]))
    for name, cfg, slots, max_len, prompts, new in runs:
        res = {}
        for which, m in (("mesh", mesh), ("unsharded", None)):
            fresh()
            eng = ServeEngine(make_arch(cfg), m, batch_slots=slots,
                              max_len=max_len, seed=0,
                              device=None if m is not None else "cuda")
            tokens, steps, rec = serve_mesh_run(eng, prompts, new)
            res[which] = {"tokens": tokens, "steps": steps, "rec": rec,
                          "peak": torch.cuda.max_memory_allocated()}
            if m is not None:
                res["reckoned"] = reckoned_serve_bytes(eng)
                layer = eng.params["layers"]
                res["blocks"] = {
                    "wq": tuple(layer["attn"]["wq"].shape),
                    "wk": tuple(layer["attn"]["wk"].shape),
                    "wi_gate": tuple((layer.get("moe") or layer["mlp"])
                                     ["wi_gate"].shape)}
                res["cache_spec"] = tuple(eng.cache_specs["k"])
            del eng
        out[name] = res
    # the SSM and hybrid configs at full width: the unsharded engine ran
    # in the parent before the ranks started (both would not fit)
    for arch_id in MESH_SSM:
        cfg = f32_config(arch_id)
        fresh()
        t0 = time.perf_counter()
        eng = ServeEngine(make_arch(cfg), mesh,
                          batch_slots=MESH_SSM_SERVE["slots"],
                          max_len=MESH_SSM_SERVE["max_len"], seed=0)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        init_peak = torch.cuda.max_memory_allocated()
        tokens, steps, rec = serve_mesh_run(eng, ssm_prompts(cfg),
                                            MESH_SSM_SERVE["new"])
        layer = eng.params["layers"]["ssm"]
        out[arch_id] = {
            "tokens": tokens, "steps": steps, "rec": rec, "init_s": init_s,
            "init_peak": init_peak,
            "peak": torch.cuda.max_memory_allocated(),
            "held": torch.cuda.memory_allocated(),
            "reckoned": reckoned_serve_bytes(eng),
            "blocks": {k: tuple(layer[k].shape)
                       for k in ("in_proj", "out_proj", "dt_proj")},
            "cache_spec": tuple(eng.cache_specs["h"])}
        del eng, layer
    out["launches"] = launch_counts()
    return out


MESH_JOBS["serve_mesh"] = mesh_serve_rank


def serve_ssm_unsharded(smi):
    """The port's unsharded engine on each config of :data:`MESH_SSM` at
    full width, one at a time, each freed before the next: what the
    (1, 2) ranks are held to."""
    import gc
    from repro_torch.models import transformer
    from repro_torch.models.registry import make_arch
    from repro_torch.serve.engine import ServeEngine
    out = {}
    for arch_id in MESH_SSM:
        cfg = f32_config(arch_id)
        base = fresh_peak()
        t0 = time.perf_counter()
        eng = ServeEngine(make_arch(cfg), batch_slots=MESH_SSM_SERVE["slots"],
                          max_len=MESH_SSM_SERVE["max_len"], seed=0,
                          device=CARD)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        tokens, steps, rec = serve_mesh_run(eng, ssm_prompts(cfg),
                                            MESH_SSM_SERVE["new"])
        out[arch_id] = {"tokens": tokens, "steps": steps, "rec": rec,
                        "peak": torch.cuda.max_memory_allocated(),
                        "params": transformer.param_bytes(eng.params)}
        log("serve_mesh", f"{arch_id} full width, float32 compute, the "
            f"unsharded engine on the card ({smi}): "
            f"{transformer.param_count(eng.params) / 1e9:.3f} B params, "
            f"init {init_s:.1f} s; tokens {tokens}; "
            f"{serve_mesh_line(rec)}; peak "
            f"{out[arch_id]['peak'] / 2**30:.3f} GiB beside the params' "
            f"{out[arch_id]['params'] / 2**30:.3f} GiB (held before "
            f"{base:.2f})")
        del eng
        gc.collect()
        torch.cuda.empty_cache()
    return out


def hold_ssm_rank(r, arch_id, plain, smi):
    """Hold rank ``r``'s (1, 2) run of ``arch_id`` to the unsharded
    engine's: logits within 1e-4 of their largest while a slot's inputs
    agree, tokens equal off counted near ties; its all-reduces and wire
    bytes per decode step equal to :func:`decode_collectives`."""
    import lm_fixture
    m = r[arch_id]
    cfg = f32_config(arch_id)
    p = np.arange(64)
    log("serve_mesh", f"gloo (1, 2) rank {r['rank']}: {arch_id} tokens "
        f"{[list(map(int, t)) for t in m['tokens']]}, the unsharded "
        f"engine's {[list(map(int, t)) for t in plain['tokens']]}; the "
        f"first step's largest |logit| {np.abs(m['steps'][0]).max():.4g} "
        f"/ {np.abs(plain['steps'][0]).max():.4g}, its largest |d| "
        f"{np.abs(m['steps'][0] - plain['steps'][0]).max():.4g}")
    res = lm_fixture.hold(lm_fixture.summarize(m["steps"], p),
                          lm_fixture.summarize(plain["steps"], p),
                          m["tokens"], plain["tokens"], "float32")
    rel = held_rel(m["steps"], plain["steps"], res["parted"])
    want_n, want_b = decode_collectives(cfg, MESH_SSM_SERVE["slots"])
    got_n, got_b = m["rec"]["decode"][0][1:]
    log("serve_mesh", f"gloo (1, 2) rank {r['rank']}: {arch_id} full width "
        f"f32, the Mamba channels on the rank ({m['blocks']}, h cache "
        f"{m['cache_spec']}), held to the unsharded engine ({smi}): "
        f"{res['held_steps']} slot steps, logits max |d| rel to their "
        f"largest {rel:.2e} (tol 1e-4), parted {res['parted']} (near ties "
        f"{res['near_ties']}); per decode step {got_n} all-reduces, "
        f"{got_b / 2**20:.4f} MiB, reckoned {want_n}, "
        f"{want_b / 2**20:.4f} MiB; {serve_mesh_line(m['rec'])}; init "
        f"{m['init_s']:.1f} s (peak {m['init_peak'] / 2**30:.3f} GiB); "
        f"peak {m['peak'] / 2**30:.3f} GiB beside the reckoned params + "
        f"cache {m['reckoned'] / 2**30:.3f} GiB (held "
        f"{m['held'] / 2**30:.3f}; ranks share the card: a record); the "
        f"unsharded engine {serve_mesh_line(plain['rec'])}")
    if rel > 1e-4 or got_n != want_n or got_b != want_b:
        raise AssertionError(f"serve_mesh {arch_id} rank {r['rank']}: rel "
                             f"{rel}, {got_n} all-reduces ({want_n}), "
                             f"{got_b} bytes ({want_b})")


def phase_serve_mesh(smi):
    """Phase 20: serving on a mesh -- ``ServeEngine(arch, mesh)`` on a
    1-rank NCCL (1, 1) mesh held to the reference's fixture, then two gloo
    ranks sharing the card on (1, 2): qwen1.5-0.5b held to the 1-rank
    run, granite-moe-1b-a400m at full width and reduced yi-6b's
    sequence-sharded 8192 cache held to the port's unsharded engine, and
    falcon-mamba-7b and zamba2-1.2b at full width with tensor-parallel
    Mamba layers held to the unsharded engine run before the ranks; no
    kernel launched."""
    import gc
    sys.path.insert(0, str(Path(__file__).resolve().parent / "tests"))
    import lm_fixture
    from repro_torch.launch import dryrun
    from repro_torch.models.registry import make_arch
    from repro_torch.parallel.mesh import make_host_mesh
    from repro_torch.serve.engine import ServeEngine
    t_phase = time.perf_counter()
    # -- the main path: counts to 0 just before, read just after ----------
    torch.cuda.synchronize()
    zero_counts()
    tree = lm_fixture.param_tree(lm_fixture.config("float32"))
    probe = lm_fixture.probe_ids(lm_fixture.config("float32"))
    one = {}
    with dryrun.one_rank_group(torch.device(CARD)):
        mesh = make_host_mesh(1, 1, device=CARD)
        for dtype in lm_fixture.DTYPES:
            cfg = lm_fixture.config(dtype)
            base = fresh_peak()
            eng = ServeEngine(make_arch(cfg), mesh,
                              batch_slots=lm_fixture.SLOTS,
                              max_len=lm_fixture.MAX_LEN)
            eng.load_params(tree)
            tokens, steps, rec = serve_mesh_run(
                eng, lm_fixture.prompts(cfg), lm_fixture.MAX_NEW)
            want_tokens, want, _ = lm_fixture.read(dtype)
            res = lm_fixture.hold(lm_fixture.summarize(steps, probe), want,
                                  tokens, want_tokens, dtype)
            one[dtype] = (tokens, steps)
            log("serve_mesh", f"qwen1.5-0.5b full width, ServeEngine on a "
                f"1-rank NCCL (1, 1) mesh, {dtype} compute, held to the "
                f"reference's fixture ({smi}): {res['held_steps']} slot "
                f"steps held, logits max |d| {res['max_err']:.3e} (tol "
                f"{lm_fixture.TOL[dtype]}), near ties {res['near_ties']}, "
                f"parted {res['parted']}; {serve_mesh_line(rec)}; peak "
                f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB "
                f"beside the reckoned params + cache "
                f"{reckoned_serve_bytes(eng) / 2**30:.3f} GiB (held "
                f"before {base:.2f})")
            if rec["decode"][0][1] != 0:
                raise AssertionError("a 1-rank mesh made collectives")
            del eng
    del tree
    gc.collect()
    torch.cuda.empty_cache()
    ssm_plain = serve_ssm_unsharded(smi)
    # -- 2 gloo ranks sharing the card on (1, 2) --------------------------
    t0 = time.perf_counter()
    outs = [o[0] for o in spawn_ranks(2, "gloo", [{"name": "serve_mesh"}])]
    f32_tokens, f32_steps = one["float32"]
    want = lm_fixture.summarize(f32_steps, probe)
    for r in outs:
        q = r["qwen"]
        res = lm_fixture.hold(lm_fixture.summarize(q["steps"], probe), want,
                              q["tokens"], f32_tokens, "float32")
        rel = max(float(np.abs(g - w).max() / np.abs(w).max())
                  for g, w in zip(q["steps"], f32_steps))
        log("serve_mesh", f"gloo (1, 2) rank {r['rank']} {r['coord']}: "
            f"qwen1.5-0.5b f32 held to the 1-rank run ({smi}): "
            f"{res['held_steps']} slot steps, tokens parted {res['parted']}"
            f" (near ties {res['near_ties']}), logits max |d| rel to their "
            f"largest {rel:.2e} (tol 1e-4); wq block {q['wq']}; "
            f"{serve_mesh_line(q['rec'])}; peak {q['peak'] / 2**30:.3f} GiB"
            f" beside the reckoned params + cache "
            f"{q['reckoned'] / 2**30:.3f} GiB (ranks share the card: a "
            f"record)")
        if rel > 1e-4:
            raise AssertionError(f"serve_mesh qwen rank {r['rank']}: {rel}")
        for name in ("granite", "yi"):
            m, u = r[name]["mesh"], r[name]["unsharded"]
            p = np.arange(min(64, m["steps"][0].shape[1]))
            res = lm_fixture.hold(lm_fixture.summarize(m["steps"], p),
                                  lm_fixture.summarize(u["steps"], p),
                                  m["tokens"], u["tokens"], "float32")
            log("serve_mesh", f"gloo (1, 2) rank {r['rank']}: {name} "
                f"({'full width, 16 experts a rank' if name == 'granite' else 'reduced, max_len 8192, cache ' + str(r[name]['cache_spec'])}"
                f") held to the unsharded engine on the card ({smi}): "
                f"{res['held_steps']} slot steps, logits max |d| "
                f"{res['max_err']:.3e} (tol 1e-3), parted {res['parted']} "
                f"(near ties {res['near_ties']}); blocks {r[name]['blocks']}"
                f"; mesh {serve_mesh_line(m['rec'])}; unsharded "
                f"{serve_mesh_line(u['rec'])}; peak {m['peak'] / 2**30:.3f}"
                f" GiB beside the reckoned {r[name]['reckoned'] / 2**30:.3f}"
                f" GiB (unsharded {u['peak'] / 2**30:.3f})")
        for arch_id in MESH_SSM:
            hold_ssm_rank(r, arch_id, ssm_plain[arch_id], smi)
        if any(r["launches"].values()):
            raise AssertionError(f"serve_mesh: kernels launched: "
                                 f"{r['launches']}")
    log("serve_mesh", f"gloo ranks in {time.perf_counter() - t0:.1f} s")
    no_launches("serve_mesh", "the LM serving path has no hand-written "
                "kernel")
    log("serve_mesh", f"phase 20 in {time.perf_counter() - t_phase:.1f} s")


def main():
    name, smi = phase_device()
    phase_build()
    rows = phase_kernel()
    dist = phase_pairwise(smi)
    phase_forward()
    launches, ms_episode = phase_episode()
    phase_env()
    phase_churn()
    phase_faults()
    reprice = phase_reprice(smi)
    phase_batch()
    phase_twin()
    phase_chaos()
    phase_diffopt()
    phase_ppo()
    phase_mesh(smi, ms_episode)
    phase_report(smi)
    phase_serve(smi)
    phase_train(smi)
    phase_mesh_lm(smi)
    phase_serve_mesh(smi)
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
        "replaces": "src/repro/kernels/pairwise_dist.py:41", **dist}, {
        "name": "reprice_cells", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/reprice_cells.cu",
        "replaces": None, "library_ms": None, **reprice}]
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()

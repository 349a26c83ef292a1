"""Drive the PyTorch port's main path once on one CUDA card.

Run from the repository root:  python3 chip_smoke.py

Phases (each prints one summary line; any failure raises, so the exit
code is non-zero and no result line is printed):

1. environment: torch / CUDA / nvcc / triton versions and the card;
2. build: compile the G1 gather kernel (csrc/stairs_gather.cu) for sm_90a;
3. kernel vs plain: G1 against its plain PyTorch version on the card,
   bit-equal at the main-path shape and the edge shapes;
4. main path: the object-motion filter at N=100K, T=10, systematic
   resampling, on cuda — G1's launch count must rise during the run — then
   the posterior against exact enumeration over 4 seeds;
5. timing: G1 against its plain version (CUDA events, medians: device
   time with calls queued back to back, and one call with the host in the
   loop), the whole filter per run at N=100K and N=1M, and a torch.profiler
   breakdown of one run (device busy time by kernel, host time by phase).

The last line is ``{"ok": true, "device": {...}}``; the line before it is
the card's name and power limit from nvidia-smi.
"""

import json
import math
import shutil
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

N_MAIN, T_MAIN, SWITCH = 100_000, 10, 5
WIDTHS = (1, 1, 1, 40)          # the main path's pieces: score, carry y,
#                                 carry moving, packed step store mat
KERNEL_SRC = "genparticlefilters_tpu_torch/csrc/stairs_gather.cu"
REPLACES = "genparticlefilters_tpu/ops/fused_gather.py:710"


def _run(cmd):
    try:
        out = subprocess.run(cmd, capture_output=True, text=True, timeout=60)
    except FileNotFoundError:
        return "not found"
    return (out.stdout + out.stderr).strip()


def _card_line():
    line = _run(["nvidia-smi", "--query-gpu=name,power.limit",
                 "--format=csv,noheader"]).splitlines()
    return line[0].strip() if line else "nvidia-smi gave no output"


def phase_environment():
    if not torch.cuda.is_available():
        raise RuntimeError("torch.cuda.is_available() is False: this script "
                           "measures the port on a CUDA card and has no CPU "
                           "fallback")
    try:
        import triton
        triton_v = triton.__version__
    except ImportError:
        triton_v = "not installed"
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    nvcc_v = _run([nvcc, "--version"]).splitlines()
    print(f"[1 env] python {sys.version.split()[0]}, torch "
          f"{torch.__version__}, torch.version.cuda {torch.version.cuda}, "
          f"triton {triton_v}, nvcc: {nvcc_v[-1] if nvcc_v else '?'}; "
          f"card: {torch.cuda.get_device_name(0)} x "
          f"{torch.cuda.device_count()}; nvidia-smi: {_card_line()}")


def phase_build():
    from genparticlefilters_tpu_torch.ops import fused_gather
    from genparticlefilters_tpu_torch.ops.build import (load_library,
                                                        build_info)
    load_library(fused_gather._LIB, fused_gather._bind)
    info = build_info(fused_gather._LIB)
    ptxas = " | ".join(l.strip() for l in info["ptxas"].splitlines()
                       if "registers" in l or "spill" in l)
    print(f"[2 build] {info['source']} -> sm_90a in {info['seconds']:.2f} s"
          f" (cached={info['cached']}); ptxas: {ptxas}")


def _weights(kind, n, dev, gen):
    if kind == "dirichlet":
        g = torch.distributions.Gamma(torch.full((n,), 0.4, device=dev),
                                      torch.ones(n, device=dev))
        w = g.sample()
    elif kind == "every8":
        w = (torch.arange(n, device=dev) % 8 == 0).float()
    elif kind == "degenerate":
        w = torch.zeros(n, device=dev)
        w[n - 1] = 1.0
    else:
        raise ValueError(kind)
    return (w / w.sum()).to(torch.float32)


def phase_kernel_vs_plain():
    from genparticlefilters_tpu_torch.ops.fused_gather import (
        resample_gather_split, resample_gather_split_plain)
    from genparticlefilters_tpu_torch.smc.resample import systematic_F
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    torch.manual_seed(0)
    cases = [(N_MAIN, N_MAIN, WIDTHS, "dirichlet"),
             (1_000_000, 1_000_000, WIDTHS, "dirichlet"),
             (4096, 4096, (9, 1), "every8"),
             (2048, 1024, (40, 1, 7), "dirichlet"),
             (600, 1200, (40, 1, 7), "dirichlet"),
             (1000, 1000, (40, 1, 7), "dirichlet"),
             (900, 900, (5,), "degenerate")]
    max_err = 0
    for n, m, widths, kind in cases:
        pieces = [torch.randint(-2**31, 2**31 - 1, (w, n), generator=gen,
                                device=dev, dtype=torch.int32)
                  for w in widths]
        F = systematic_F(gen, _weights(kind, n, dev, gen), n_out=m)
        outs, parents = resample_gather_split(pieces, F, n_out=m)
        torch.cuda.synchronize()
        ref_outs, ref_par = resample_gather_split_plain(pieces, F, n_out=m)
        torch.cuda.synchronize()
        if not torch.equal(parents, ref_par):
            raise AssertionError(f"G1 parents differ at n={n} m={m} {kind}")
        for o, r in zip(outs, ref_outs):
            err = int((o.long() - r.long()).abs().max().item()) if m else 0
            max_err = max(max_err, err)
            if not torch.equal(o, r):
                raise AssertionError(f"G1 rows differ at n={n} m={m} {kind}")
        print(f"[3 kernel] n={n} n_out={m} widths={widths} {kind}: "
              f"bit-equal to plain")
    return max_err


def phase_main_path():
    import genparticlefilters_tpu_torch as g
    from genparticlefilters_tpu_torch.models.object_motion import (
        synthesize_data, object_motion_filter, exact_posterior)
    from genparticlefilters_tpu_torch.ops.fused_gather import (
        resample_gather_split)
    dev = torch.device("cuda")
    y_obs, _ = synthesize_data(torch.Generator(device=dev).manual_seed(42),
                               T_MAIN, SWITCH)

    resample_gather_split.launches = 0
    st = object_motion_filter(torch.Generator(device=dev).manual_seed(100),
                              y_obs, N_MAIN, T_MAIN)
    torch.cuda.synchronize()
    launches = resample_gather_split.launches
    if launches < 1:
        raise AssertionError("the main path never launched G1")
    lml = float(g.log_ml_estimate(st))
    if not math.isfinite(lml):
        raise AssertionError(f"log_ml_est is not finite: {lml}")
    store = st.traces.inner["store"]
    for leaf in (st.traces.score, store.mat, *st.traces.inner["carry"]):
        if leaf.device.type != "cuda":
            raise AssertionError(f"trace leaf on {leaf.device}")
    if tuple(store.mat.shape) != (4 * T_MAIN, N_MAIN):
        raise AssertionError(f"store shape {tuple(store.mat.shape)}")
    print(f"[4 main] object_motion_filter N={N_MAIN} T={T_MAIN} systematic "
          f"on cuda: G1 launches {launches}, LML {lml:.4f}, "
          f"mat {tuple(store.mat.shape)} int32 on cuda")

    post, exact_lml = exact_posterior(y_obs.cpu().numpy())
    res, lmls = [], []
    for s in range(4):
        sti = object_motion_filter(
            torch.Generator(device=dev).manual_seed(200 + s), y_obs, N_MAIN,
            T_MAIN)
        res.append([float(g.mean(sti, (t, "moving")))
                    for t in range(T_MAIN)])
        lmls.append(float(g.log_ml_estimate(sti)))
    res = np.array(res)
    est = res.mean(0)
    stderr = res.std(0) / math.sqrt(len(res)) + 1e-3
    worst = float(np.max(np.abs(est - post) - (6 * stderr + 0.03)))
    if worst >= 0:
        raise AssertionError(f"posterior off: est {est} exact {post}")
    if abs(np.mean(lmls) - exact_lml) >= 0.2:
        raise AssertionError(f"LML {np.mean(lmls)} vs exact {exact_lml}")
    print(f"[4 posterior] 4 seeds: P(moving@t) max |est-exact| "
          f"{float(np.max(np.abs(est - post))):.4f} (limit 6*stderr+0.03), "
          f"mean LML {np.mean(lmls):.4f} vs exact {exact_lml:.4f}")
    return launches


def _event_ms(fn, reps):
    """Per-call time of ``fn`` with the host in the loop: one call between
    two events, the device idle while the host launches."""
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return times


def _queued_ms(fn, calls=20):
    """Device time per call: the stream is held busy (torch.cuda._sleep)
    while the host queues ``calls`` calls, so they run back to back and
    host launch time is hidden."""
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(200_000_000)
    a.record()
    for _ in range(calls):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / calls


def _gather_timing(n, card):
    from genparticlefilters_tpu_torch.ops.fused_gather import (
        resample_gather_split, resample_gather_split_plain)
    from genparticlefilters_tpu_torch.smc.resample import systematic_F
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)
    pieces = [torch.randint(-2**31, 2**31 - 1, (w, n), generator=gen,
                            device=dev, dtype=torch.int32) for w in WIDTHS]
    F = systematic_F(gen, _weights("dirichlet", n, dev, gen))
    kern = lambda: resample_gather_split(pieces, F)          # noqa: E731
    plain = lambda: resample_gather_split_plain(pieces, F)   # noqa: E731
    for _ in range(3):
        kern()
        plain()
    torch.cuda.synchronize()
    k_call, p_call, k_dev, p_dev = [], [], [], []
    for _ in range(6):   # in turns: plain, kernel, kernel, plain
        p_call += _event_ms(plain, 2)
        k_call += _event_ms(kern, 4)
        p_call += _event_ms(plain, 2)
        p_dev.append(_queued_ms(plain))
        k_dev.append(_queued_ms(kern))
        k_dev.append(_queued_ms(kern))
        p_dev.append(_queued_ms(plain))
    med = statistics.median
    gbytes = 2 * sum(WIDTHS) * 4 * n / 1e9
    print(f"[5 G1] N={n} widths={WIDTHS}: device time per call (20 queued "
          f"calls, median of {len(k_dev)}) kernel {med(k_dev):.4f} ms "
          f"({gbytes / (med(k_dev) / 1e3):.0f} GB/s of {gbytes * 1e3:.1f} MB)"
          f", plain {med(p_dev):.4f} ms; one call with the host in the "
          f"loop (median of {len(k_call)}) kernel {med(k_call):.4f} ms, "
          f"plain {med(p_call):.4f} ms; card {card}")
    return med(k_dev), med(p_dev)


def _profile_filter(y_obs, n, per_run, card):
    """Where a filter run's time goes: device busy time by kernel and host
    time by phase span (om.* record_function spans), from torch.profiler."""
    from torch.profiler import profile, ProfilerActivity
    from genparticlefilters_tpu_torch.models.object_motion import (
        object_motion_filter)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(400)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 acc_events=True) as prof:
        object_motion_filter(gen, y_obs, n, T_MAIN)
        torch.cuda.synchronize()
    ka = prof.key_averages()
    cuda = torch.autograd.DeviceType.CUDA
    kern = [e for e in ka
            if e.device_type == cuda and not e.key.startswith("om.")]
    busy_ms = sum(e.self_device_time_total for e in kern) / 1e3
    if busy_ms <= 0:
        print(f"[5 profile] N={n}: the profiler showed no device time; "
              f"device busy share not measured")
        return
    n_kern = sum(e.count for e in kern)
    top = sorted(kern, key=lambda e: -e.self_device_time_total)[:5]
    tops = "; ".join(f"{e.key[:40]} x{e.count} "
                     f"{e.self_device_time_total / 1e3:.3f} ms" for e in top)
    print(f"[5 profile] N={n}: {n_kern} kernels, device busy {busy_ms:.3f} "
          f"ms of {per_run * 1e3:.3f} ms/run unprofiled (idle share "
          f"{max(0.0, 1 - busy_ms / (per_run * 1e3)):.3f}); top: {tops}")
    phases = []
    for e in sorted((e for e in ka if e.key.startswith("om.")),
                    key=lambda e: (e.key, e.device_type != cuda)):
        where, ms = (("device span", e.device_time_total)
                     if e.device_type == cuda else
                     ("host", e.cpu_time_total))
        phases.append(f"{e.key} x{e.count} {where} {ms / 1e3:.2f} ms")
    print(f"[5 profile] N={n} by phase (profiled run): {'; '.join(phases)}"
          f"; card {card}")


def phase_timing(card):
    from genparticlefilters_tpu_torch.models.object_motion import (
        synthesize_data, object_motion_filter)
    k_ms, p_ms = _gather_timing(N_MAIN, card)
    _gather_timing(1_000_000, card)
    dev = torch.device("cuda")
    y_obs, _ = synthesize_data(torch.Generator(device=dev).manual_seed(42),
                               T_MAIN, SWITCH)
    filt = {}
    for n in (N_MAIN, 1_000_000):
        runs = []
        for s in range(6):
            g2 = torch.Generator(device=dev).manual_seed(300 + s)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            object_motion_filter(g2, y_obs, n, T_MAIN)
            torch.cuda.synchronize()
            runs.append(time.perf_counter() - t0)
        per_run = statistics.median(runs[1:])   # first run warms up
        filt[n] = per_run
        print(f"[5 filter] N={n} T={T_MAIN}: {per_run * 1e3:.3f} ms/run "
              f"(median of {len(runs) - 1} after a warm-up; min "
              f"{min(runs[1:]) * 1e3:.3f}, max {max(runs[1:]) * 1e3:.3f}), "
              f"{n * T_MAIN / per_run:,.0f} particle-updates/s; card {card}")
        _profile_filter(y_obs, n, per_run, card)
    return k_ms, p_ms, filt


def main():
    phase_environment()
    card = _card_line()
    phase_build()
    max_err = phase_kernel_vs_plain()
    launches = phase_main_path()
    k_ms, p_ms, _ = phase_timing(card)
    print(json.dumps({"kernels": [{
        "name": "stairs_gather (G1)", "route": "cuda", "source": KERNEL_SRC,
        "replaces": REPLACES, "launches": launches, "max_abs_err": max_err,
        "ms": k_ms, "plain_ms": p_ms}]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()

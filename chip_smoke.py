"""Drive the PyTorch port's paths once on one CUDA card.

Run from the repository root:
    python3 chip_smoke.py [--against DIR] [--config34-only]

Phases (each prints summary lines; any failure raises, so the exit code is
non-zero and no result line is printed):

1. environment: torch / CUDA / nvcc / triton versions, the card, its
   driver, whether PyTorch has CUDA conditional nodes
   (``CUDAGraph.begin_capture_to_if_node``), the CUDA runtime (torch's
   and the toolkit's) and driver versions, and whether IF nodes with an
   ELSE body are available (12.8 or later on both);
2. build: compile the kernels for sm_90a, one nvcc per source, side by
   side: G1 (csrc/stairs_gather.cu), G2 (csrc/stairs_gather_u.cu), G3
   (csrc/gather_parents.cu, column and row mode), G4
   (csrc/merge_count.cu), G5 (csrc/max_scan.cu), the ESS check
   (csrc/ess_check.cu) and the conditional-node shim
   (csrc/graph_cond.cu, which refuses a toolkit older than 12.8), whose
   runtime and driver versions are printed;
3. kernel vs plain: each kernel against its plain PyTorch version on the
   card, bit-equal at the main-path shapes and the edge shapes (G1 and G2
   also at a 1026-row pack; G4 also at skewed inputs: degenerate weights,
   all-equal u, n or m = 1, m = 4n and n = 4m, m = 0; G3's row mode at
   widths 1-16, a view off a 16-byte boundary, M = N/4 and 4N, extreme
   bit patterns; G5 on int32 and float32 rows around its tiles, with
   one-ulp dips, NaN and signed zeros, against torch.cummax; the ESS
   check at N = 1 to 1M on random, degenerate, equal, wide, partly -inf,
   NaN, all -inf and +inf weights and on misaligned views: its predicate
   equal to the logsumexp chain's at 8 thresholds (ess_frac 1 on equal
   weights included), its ESS within 1e-5 of the chain's; then 20
   replays of captured checks bit-equal, and
   the graph nodes inside one ess_check span, the kernel's against the
   chain's); graph_cond: a donating toy device_cond on a state of
   three 1M-element leaves (the branch draws) in three forms (the state
   made in the run: one body, both replaced leaves donated; the static
   inputs themselves: both buffered behind an ELSE body; a kept static
   input: an empty ELSE body), each captured as an IF node and as the
   select, replayed with the predicate flipped through its input buffer,
   every replay bit-equal to the select's from one seed, to the eager run
   where taken and to the incoming state where not; copy_leaves (the IF
   bodies' one copy kernel) bit-equal to its plain version on the
   headline's 8 replaced leaves at N=100K and 1M, on views off a 16-byte
   boundary with odd byte counts, and on 130 leaves (two launches);
4. main path: the object-motion filter at N=100K, T=10, systematic
   resampling, on cuda — G1's and the ESS check's launch counts must rise
   during the run — then
   the posterior against exact enumeration over 4 seeds;
4a-4e. the other paths, each with every launch count set to 0 just before
   it and read just after: (a) residual resampling at N=100K (G2 counting
   the remainder, then G1), (b) the same at the README size N=100,
   (c) multinomial and unsorted stratified at N=100K (G2 with data), each
   with the posterior check; (d) sub-state resampling of two halves of
   the N=100K state, multinomial and residual (G4), with the block-LML,
   global-LML and block-ancestry checks; (e) the linear-Gaussian filter
   at N=10K, T=8, systematic and stratified, against the Kalman filter;
4f-4i. config 5, multi-object tracking (K=4 objects): (f) N=1M, T=10 on
   the resize schedule of scripts/config45_bench.py (systematic
   resampling, residual resize to N/2, multinomial resize back to N), then
   optimal resize to N/4, replicate x4 and dereplicate, with the posterior
   and LML checks (G1, G2, G3); (g) the wide-pack route, T=64 (1025 packed
   rows), multinomial at N=100K (G2) and systematic at N=1000 (G1);
   (h) blockwise resampling of the (f) state in 4 blocks, every method,
   then block rotation and shuffle (G1, G2, G3); (i) the data-association
   model at N=100K, K=3, T=5, associations recovered; (f) and (h) print
   the widths of the particle-first leaves they hand to G3's row mode;
4j. a model with an 8-wide vector site at N=1M (its [N, 8] leaves take
   G3's row mode): sorted stratified resampling, sub-state resampling of
   two halves (G4), optimal resize to N/4 and block rotation, each against
   the exact posterior and LML and the ancestry check (G3 rows, G4);
4k. first, on 1M weights of which 90% are exactly 0, no resampling route
   (G1, G2, G4, stratified F) picks a zero-weight particle; then config
   3, the stochastic-volatility filter with move-reweight rejuvenation,
   N=100K, T=100, window 2 (G1): finite weights, ESS in [1, N], posterior
   variance of h_{T-1} > 0, and the mean LML of 4 seeds against an
   independent bootstrap filter written here at N=1M (4 seeds), within
   6·(combined stderr) + 0.05, every seed within 1 nat;
4l. config 4, tempered SMC by args-update, N=100K, 50 temperatures, two
   MH sweeps after each resampling (G1): mean LML of 4 seeds within
   6·stderr + 0.02 of the quadrature log Z, both modes > 5% of the
   weight, > 95% of it within 1.2 of a mode;
4m. config 4 by SMCP³: the same loop with the args-update replaced by
   pf_update(translator=UpdatingTraceTranslator) (eps ~ N(0, 0.25) both
   ways, x' = x + eps; G1), the same LML gate; then one translator step
   with x' = x·exp(eps) at N=100K, whose weights (vmapped jacfwd
   log-determinants) must equal their float64 recomputation within 5e-4;
4n. stratified pf_initialize and pf_update on a small plain model at
   N=100K with exact weights; assess of choices built from Python values
   scoring on the card with no host sync; and pf_update / pf_rejuvenate (move and
   reweight) on half views of object-motion states: the other half
   bit-unchanged, the view as the verb run on the taken block;
4o. the line model of tests/fixtures.py (a @gen calling an Unfold at
   "line"), N=100K, T=10, data y_0..y_9 from its generate with slope = 1,
   driven as the reference README drives it: when the ESS falls below
   N/2, resample and MH on the slope with the full re-scan regenerate,
   then pf_update with the next y. Route A updates by UnknownChange (the
   full re-scan through the call site) and resamples systematically (G1);
   route B by Extend(1, at="line") and residually (G2 count + G1). Each
   route: one counted run (at most one host sync per step, the ESS `if`),
   then 4 seeds against the exact enumeration over the slope: mean LML
   within 6·stderr + 0.05 of log Z, every seed within 0.5, P(slope = s)
   within 6·stderr + 0.02;
4p. a MapCombinator plate, N=100K: mu ~ N(0, 1), x_i ~ N(mu, 1), y_i ~
   N(x_i, 0.5) = 0.5 for i < 8; pf_initialize, systematic resampling (G1
   gathers the [N, 8] plate leaves) and two MH sweeps on mu through the
   call site, with no host sync; over 8 seeds the mean LML within 0.05 of
   the conjugate log Z and the posterior mean of mu within
   6·stderr + 0.02;
4q-4s. the per-particle interpretation (``vmap_gfi``), each with its launch
   counters reset before and read after, no vmap fallback and at most the
   ESS checks' host syncs: (q) the object-motion filter with its step body
   unmarked, N=100K, systematic (G1) and residual (G2 count + G1), against
   phase 4's posterior gate; (r) the line model unmarked, route B (4o's
   gate), and the SMCP³ loop of 4m with its proposals unmarked (4m's
   gate); (s) a model only the per-particle path reads right, mu ~
   mvnormal_diag(0, I_3), y_i ~ N(mu[0] + mu[1]·x_i + mu[2]·x_i², 1), N=100K,
   resampled (G1) and moved by MH on mu, 8 seeds against the conjugate log
   Z and posterior mean; and the batched-layout guard's collision model
   raising at N=64 and running at N=32;
   dists: the 19 distributions' log_prob on the card against the CPU and
   1M draws each against closed-form moments; ckpt: save_state and
   restore_state of a 4q state, restored leaves and the next pf_update
   bit-equal; repro: torch.cumsum repeated on one input (the evidence),
   then routes 4o B and 4c multinomial twice here and once in a fresh
   process (``--repro-only``), bit-equal;
4t-4v. combinators nested in combinators, linear-Gaussian, N=100K, T=10,
   each with its launch counters reset before and read after, at most
   the 9 ESS checks' host syncs and its Unfold step bodies counted, then
   4 seeds against the exact Kalman log Z (mean within 6·stderr + 0.05,
   every seed within 0.5): (t) N1, a plate of 8 observations in an Unfold
   step, Extend(1), systematic (G1), MH on x through the window-2
   regenerate; (u) N2, a plate of 4 Unfolds, full re-scan updates,
   residual (G2 count + G1); (v) N3, an Unfold of 3 sub-steps in an
   Unfold step, Extend(1), systematic (G1), batched and unmarked (per
   particle through vmap_gfi, no vmap fallback);
4w. the step of dryrun_multichip (__graft_entry__.py) at full width on a
   state sharded over a one-rank NCCL mesh (NCCL takes one rank per
   card; four-rank semantics are held on the CPU by
   tests/test_torch_mesh.py): object motion N=100K, T=10, four steps of
   an update, the ESS-triggered blockwise resample + ring rotation +
   shuffle, MH, the exact global resample and a translator update (G1);
   every leaf bit-equal to the same steps with mesh=None from the same
   seed, each blockwise resample without a collective or a
   torch.distributed call;
4x. (run last, after phases 5 and 6) the compiled drivers
   (smc/capture.py): each filter run captured once as a CUDA graph, each
   ESS branch an IF node that donates the state (csrc/graph_cond.cu: only
   the taken body runs, the predicate read on the card, and a taken
   branch's result is written back into the state by one copy_leaves
   launch), captured again in the buffered form (capture's private
   ``_buffered_form``: every replaced leaf copied into a buffer, by THEN
   from the result and by an ELSE body from the incoming leaf) and in the
   select form (the branch always runs, its leaves chosen by
   torch.where) as the yardstick; replayed: the headline at N=100K and
   1M, T=10, systematic (G1 a node in the THEN body) and residual (G2
   count + G1), config 2 (the linear-Gaussian filter, N=10K, T=8), 4k SV
   (99 branches), 4l tempered (49 branches) and config 5's filter (MOT
   K=4, N=1M, T=10, no resizes). Each cell: (a) with every branch forced
   (ess_frac 1.5) the donated replay from a fresh seed bit-equal, leaf
   for leaf, to the eager run from that seed, and two replays from one
   seed to each other; (g) the donated replay bit-equal to the buffered
   and select replays from one seed, forced and at the default ess_frac;
   at the default ess_frac (f) each form's capture time and pool memory,
   the kernels captured as graph nodes, the IF nodes per graph, which
   must equal the ESS checks per run (9, 9, 7, 99, 49, 9), those with an
   ELSE body and the leaves donated and buffered, (b) the eager cell's
   gate on donated replays (the registered generator reseeded before
   each): exact enumeration over 4 seeds, the Kalman filter, the
   bootstrap LML, the quadrature log Z, config 5's posterior means; (c)
   0 host syncs per donated and buffered replay (the eager run's printed
   beside); (e) ms/run of the donated, buffered and select replays and
   the eager run in turns, median of 5; (d) one profiled run of each,
   after a profiled warm-up run: kernels, device busy ms, idle share,
   busy over the eager run's and the kernels whose device time differs
   most (of two profiled runs the one with the most kernels: a profile
   drops records), failing where the donated replay shows no device time
   or no G1 (G2) kernel, or where a profiled IF replay's copy_leaves runs
   (counted on the card by the kernel itself) differ from its taken
   checks (each IF node's predicate as the replay read it) plus, untaken,
   its nodes that buffer, the replays profiled from the first seed of
   971-986 whose donated replay resampled; the forced
   checks come last in a cell, with each form's profiled busy ms. Every
   captured run is kept until 4x ends (once a graph is
   destroyed the profiler names the kernels in a later graph's IF bodies
   after the destroyed graph's); the last cell frees them before its
   forced runs. Every cell runs before a failure is raised;
5. timing: each kernel against its plain version and, where one PyTorch
   call computes the same function, that call (CUDA events, medians:
   device time with calls queued back to back, and one call with the host
   in the loop), with its bound (the bytes it must move over 3.35 TB/s)
   and its share of the bound, at N=100K and N=1M (the ESS check also at
   500K, alone with L2 flushed too, beside the chain and
   torch.logsumexp); the toy device_cond of
   phase 3 as an IF graph against its select graph, each replay one call,
   at both predicates, in the donated and buffered forms; copy_leaves on
   the headline's 8 replaced leaves at N=100K and 1M (bound: each byte
   read once and written once) against its plain version and
   torch._foreach_copy_; G4 also at the skewed
   inputs and G3's row mode at widths 1, 8 and 16; the whole filter per
   run at N=100K and N=1M for systematic, residual and multinomial
   resampling; the host syncs of one run (at most 9, the ESS checks); a
   torch.profiler breakdown of the systematic and residual runs (device
   busy time by kernel, host time by phase); and for config 5 the run
   time, each resize verb's time, the host syncs of one run and a profiler
   breakdown; for configs 3 and 4 (4k, 4l, 4m) the ms per run, a profiler
   breakdown by sv.*/tm.* span, the host syncs of one run (at most the
   ESS checks: 99 and 49) and G1's launches per run; the weights' cumsum
   in float32 and float64; and the cost of the store copy that each
   windowed SV rejuvenation makes;
   the headline with the batched-layout guard on and off in turns, and a
   cold guarded run's host syncs and kernels against an unguarded run's;
   4q, 4r, 4s and 4v per particle beside their batched counterparts in turns
   (ms/run, kernels, device busy and idle share, boundary copies), one 4q
   run through utils.profiling.trace_profile;
   Configs 3 and 4 and the cells 4o (both routes), 4p, 4t-4v and 4w are
   timed in turns beside the object-motion filter twice: at the start of phase 5
   and after config 5 (there also with the cyclic GC off and after
   emptying the allocator's cache), each with its kernels per run, device
   busy time and idle share from the profiler, and 4o with the Unfold
   step bodies one run executes per route;
6. only with ``--against DIR``: DIR holds earlier versions of
   merge_count.cu and gather_parents.cu (same C entry points as the ones
   they precede); they are built under other library names and timed
   against this tree's G4 and G3 in turns (earlier, this, this, earlier)
   at the shapes of phase 5.

Last, after 4x: every ESS check of one seed's sequence pool in each graph
cell of the benchmark, evaluated by the kernel and by the chain inside
the cell's captured graph, with the kernel's predicate driving the run:
the predicates that differ, each printed with its ESS and threshold.

``--config34-only`` builds, times configs 3 and 4 beside object motion
in its own fresh process, and stops there, with no result line;
``--repro-only`` builds, runs 4o B and 4c multinomial once and prints
their LML bits as JSON (no result line).

The line before the last is the card's name and power limit from
nvidia-smi; before it, a JSON line lists each kernel with its launches on
the path that exercises it ((4) for G1 and the ESS check, (4a) for G2, (4f) for G3's column
mode, (4j) for its row mode, (4d) for G4, the IF nodes and copy_leaves
launches of 4x's headline capture at N=100K for graph_cond and
copy_leaves), its largest error against the plain version, its device
time at N=100K beside its plain version's (for graph_cond the toy's
untaken donated IF replay beside the select's, bound by the predicate's
one byte), the library call's (or null) and its bound.
The last line is ``{"ok": true, "device": {...}}``.
"""

import argparse
import collections
import contextlib
import ctypes
import gc
import importlib
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import time
import traceback
import warnings

import numpy as np
import torch
import torch.distributed

N_MAIN, T_MAIN, SWITCH = 100_000, 10, 5
N_SMALL = 100                   # the README's config-1 particle count
WIDTHS = (1, 1, 1, 40)          # the main path's pieces: score, carry y,
#                                 carry moving, packed step store mat
N_C5, T_C5 = 1_000_000, 10      # config 5 at its published size
N_VEC, D_VEC, Y_VEC = 1_000_000, 8, 2.0   # path 4j: x ~ N(0, I_8),
#                                           y ~ N(sum(x), 1), y = 2
WIDTHS_C5 = (1, 160)            # its pieces: score, mat (16 rows per step)
T_WIDE = 64                     # 16*64 + 1 = 1025 packed rows: past the
#                                 TPU lane kernels' 1022-row cap
N_SV, T_SV = 100_000, 100       # config 3 (BASELINE.json, scripts/sv_bench.py)
N_SV_REF = 1_000_000            # its independent bootstrap reference
N_TM, K_TM = 100_000, 50        # config 4: particles, temperatures
N_STRATA = 100_000              # path 4n
N_LINE, T_LINE = 100_000, 10    # path 4o: the line model of tests/fixtures.py
N_PLATE, D_PLATE, Y_PLATE = 100_000, 8, 0.5   # path 4p: mu ~ N(0, 1),
#                                 x_i ~ N(mu, 1), y_i ~ N(x_i, 0.5) = 0.5
N_NEST, T_NEST = 100_000, 10    # paths 4t-4v: nested combinators
A_NEST, Q_NEST, R_NEST = 0.7, 0.6, 0.5   # their AR coefficient, process
#                                 and observation sd
K1_NEST, K2_NEST, S3_NEST = 8, 4, 3   # N1's plate, N2's plate, N3's
#                                 inner sub-steps
SPANS = ("om.", "c5.", "sv.", "tm.", "lm.", "mp.", "ns.", "mw.",
         "smc.")                # profiler span prefixes of the runs (smc.:
#                                 run_particle_filter's default, configs 2, 5)
MAX_SYNCS = 9                   # per object-motion run: the 9 ESS checks
HBM_BYTES_PER_MS = 3.35e9       # the H100 SXM's 3.35 TB/s
CSRC = "genparticlefilters_tpu_torch/csrc/"
TPU = "genparticlefilters_tpu/ops/"
# name -> (source, the TPU kernel it replaces)
KERNELS = {
    "stairs_gather (G1)": (CSRC + "stairs_gather.cu",
                           TPU + "fused_gather.py:710"),
    "stairs_gather_u (G2)": (CSRC + "stairs_gather_u.cu",
                             TPU + "fused_gather.py:710 (is_float=True), "
                             + TPU + "fused_gather.py:196"),
    "gather_parents (G3)": (CSRC + "gather_parents.cu",
                            TPU + "fused_gather.py:250, "
                            + TPU + "fused_gather.py:1014"),
    "gather_parents rows (G3r)": (CSRC + "gather_parents.cu",
                                  TPU + "gather.py:30, "
                                  + TPU + "sorted_gather.py:38"),
    "merge_count (G4)": (CSRC + "merge_count.cu", TPU + "merge_count.py:41"),
    # not a Pallas kernel: the JAX package's running maximum is a blocked
    # cummax that XLA lowers
    "max_scan (G5)": (CSRC + "max_scan.cu",
                      "genparticlefilters_tpu/smc/resample.py:70 (_cummax1; "
                      "not a TPU kernel)"),
    # not a TPU kernel: the IF node is XLA's conditional, lax.cond's
    # lowering under jit, and its plain version is capture's _select
    "graph_cond (IF)": (CSRC + "graph_cond.cu",
                        "genparticlefilters_tpu/smc/algorithms.py:65, :112, "
                        "genparticlefilters_tpu/models/object_motion.py:107 "
                        "(lax.cond; not a TPU kernel)"),
    # the IF node's copy: lax.cond's result in its dead operand's buffers
    "copy_leaves (CL)": (CSRC + "graph_cond.cu",
                         "genparticlefilters_tpu/smc/algorithms.py:65, :112, "
                         "genparticlefilters_tpu/models/object_motion.py:107"
                         " (lax.cond's result written into its operand's "
                         "buffers; not a TPU kernel)"),
    # not a TPU kernel: the JAX package's ESS check is a logsumexp chain
    # that XLA fuses under jit
    "ess_check (ESS)": (CSRC + "ess_check.cu",
                        "genparticlefilters_tpu/utils/weights.py:56 "
                        "(ess_from_log_weights and the compare; not a TPU "
                        "kernel)"),
}
G1, G2, G3, G3R, G4, G5, GC, CL, ESS = KERNELS
N_TOY = 1 << 20                 # phase 3's device_cond state: 1M per leaf
# every captured run, kept until 4x ends: once a graph is destroyed, the
# profiler names the kernels in a later graph's IF bodies after the
# destroyed graph's (seen on the card: config 2 after the headline, its G1
# reported under other kernels' names)
_KEPT = []


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


def _wrappers():
    """Kernel name -> its wrapper (each carries a ``launches`` count)."""
    from genparticlefilters_tpu_torch.ops.fused_gather import (
        resample_gather_split, resample_gather_split_u)
    from genparticlefilters_tpu_torch.ops.gather import (gather_cols,
                                                         gather_rows)
    from genparticlefilters_tpu_torch.ops.graph_cond import (copy_leaves,
                                                             if_node)
    from genparticlefilters_tpu_torch.ops.ess_check import ess_below
    from genparticlefilters_tpu_torch.ops.max_scan import max_scan
    from genparticlefilters_tpu_torch.ops.merge_count import merge_count
    return dict(zip(KERNELS, (resample_gather_split, resample_gather_split_u,
                              gather_cols, gather_rows, merge_count,
                              max_scan, if_node, copy_leaves, ess_below)))


def _capture_module():
    """``smc/capture.py`` itself (the package's ``capture`` attribute is
    the function)."""
    return importlib.import_module("genparticlefilters_tpu_torch.smc.capture")


def _reset_counts():
    for fn in _wrappers().values():
        fn.launches = 0


def _counts():
    return {name: fn.launches for name, fn in _wrappers().items()}


def _short(counts):
    return ", ".join(f"{k.split()[-1][1:-1]} {v}" for k, v in counts.items())


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
    driver = _run(["nvidia-smi", "--query-gpu=driver_version",
                   "--format=csv,noheader"]).splitlines()
    toolkit = re.search(r"release (\d+)\.(\d+)", "\n".join(nvcc_v))
    toolkit = (int(toolkit[1]), int(toolkit[2])) if toolkit else None
    drv = ctypes.c_int(0)
    ctypes.CDLL("libcuda.so.1").cuDriverGetVersion(ctypes.byref(drv))
    drv = (drv.value // 1000, drv.value % 1000 // 10)
    print(f"[1 env] python {sys.version.split()[0]}, torch "
          f"{torch.__version__}, torch.version.cuda {torch.version.cuda}, "
          f"triton {triton_v}, nvcc: {nvcc_v[-1] if nvcc_v else '?'}; "
          f"card: {torch.cuda.get_device_name(0)} x "
          f"{torch.cuda.device_count()}; nvidia-smi: {_card_line()}; "
          f"driver {driver[0].strip() if driver else '?'}; "
          f"torch.cuda.CUDAGraph has begin_capture_to_if_node: "
          f"{hasattr(torch.cuda.CUDAGraph, 'begin_capture_to_if_node')}")
    print(f"[1 env] CUDA runtime: torch's {torch.version.cuda}, the "
          f"toolkit's (nvcc, linked into csrc/graph_cond.cu) "
          f"{'.'.join(map(str, toolkit)) if toolkit else '?'}; the "
          f"driver's CUDA {drv[0]}.{drv[1]}; IF nodes with an ELSE body "
          f"(toolkit and driver 12.8 or later): "
          f"{bool(toolkit and toolkit >= (12, 8) and drv >= (12, 8))}")


def phase_build():
    from genparticlefilters_tpu_torch.ops.build import load_all, build_info
    t0 = time.perf_counter()
    libs = load_all()
    wall = time.perf_counter() - t0
    for lib in libs:
        info = build_info(lib)
        ptxas = " | ".join(l.strip() for l in info["ptxas"].splitlines()
                           if "registers" in l or "spill" in l)
        print(f"[2 build] {info['source']} -> sm_90a in "
              f"{info['seconds']:.2f} s (cached={info['cached']}); "
              f"ptxas: {ptxas}")
    print(f"[2 build] {len(libs)} libraries built side by side in "
          f"{wall:.2f} s")
    from genparticlefilters_tpu_torch.ops.graph_cond import versions
    v = versions()
    print(f"[2 build] graph_cond: built against CUDA runtime "
          f"{v['runtime']}, driver CUDA {v['driver']} (an IF node's ELSE "
          f"body needs 12080 on both)")


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


def _pieces(widths, n, dev, gen):
    return [torch.randint(-2**31, 2**31 - 1, (w, n), generator=gen,
                          device=dev, dtype=torch.int32) for w in widths]


def _max_err(outs, refs):
    return max([int((o.long() - r.long()).abs().max().item())
                for o, r in zip(outs, refs) if o.numel()] + [0])


def _check_G1(dev, gen):
    from genparticlefilters_tpu_torch.ops.fused_gather import (
        resample_gather_split, resample_gather_split_plain)
    from genparticlefilters_tpu_torch.smc.resample import systematic_F
    cases = [(N_MAIN, N_MAIN, WIDTHS, "dirichlet"),
             (1_000_000, 1_000_000, WIDTHS, "dirichlet"),
             (N_SMALL, N_SMALL, WIDTHS, "dirichlet"),
             (4096, 4096, (9, 1), "every8"),
             (2048, 1024, (40, 1, 7), "dirichlet"),
             (600, 1200, (40, 1, 7), "dirichlet"),
             (1000, 1000, (40, 1, 7), "dirichlet"),
             (900, 900, (5,), "degenerate"),
             (N_MAIN, N_MAIN, (1, 16 * T_WIDE + 1), "dirichlet")]
    max_err = 0
    for n, m, widths, kind in cases:
        pieces = _pieces(widths, n, dev, gen)
        F = systematic_F(gen, _weights(kind, n, dev, gen), n_out=m)
        outs, parents = resample_gather_split(pieces, F, n_out=m)
        torch.cuda.synchronize()
        ref_outs, ref_par = resample_gather_split_plain(pieces, F, n_out=m)
        torch.cuda.synchronize()
        max_err = max(max_err, _max_err(outs, ref_outs),
                      _max_err([parents], [ref_par]))
        if not torch.equal(parents, ref_par) or not all(
                torch.equal(o, r) for o, r in zip(outs, ref_outs)):
            raise AssertionError(f"G1 differs at n={n} m={m} {kind}")
        print(f"[3 G1] n={n} n_out={m} widths={widths} {kind}: "
              f"bit-equal to plain")
    return max_err


def _brackets(n, m, kind, dev, gen):
    """Float brackets c [n] (a zero-weight run, cummax-guarded, normalized)
    and sorted queries u [m], with the edge cases of the G2 contract."""
    w = _weights("dirichlet", n, dev, gen)
    w[5:9] = 0.0
    c = torch.cummax(torch.cumsum(w, 0), 0).values
    c = c / c[-1]
    u = torch.sort(torch.rand(m, generator=gen, device=dev)).values
    if kind == "zero_u":
        u[0] = 0.0                        # clamped to 1e-37 in the kernel
    elif kind == "short_c":
        c = c * 0.999                     # max(u) > c[-1]: the catch-all
        u[-3:] = 0.9995
        u = torch.sort(u).values
    return c.contiguous(), u.contiguous()


def _residual_queries(n, dev, gen):
    """The role-swapped inputs of residual_F_fused at n: brackets = sorted
    remainder uniforms (1.5/1.75 padded), queries = the residual cumsum."""
    from genparticlefilters_tpu_torch.smc import resample as R
    w = _weights("dirichlet", n, dev, gen)
    det, n_res, resid = R._residual_split(w, n)
    rc = torch.clamp_min(R._normalized(torch.cummax(
        torch.cumsum(resid, 0), 0).values), 1e-30)
    ce = R._sorted_uniforms_cum(gen, n, dev)
    return R._residual_u(ce, n_res, n), rc


def _check_G2(dev, gen):
    from genparticlefilters_tpu_torch.ops.fused_gather import (
        resample_gather_split_u, resample_gather_split_u_plain)
    cases = [(N_MAIN, N_MAIN, WIDTHS, "plain"),
             (1_000_000, 1_000_000, WIDTHS, "plain"),
             (N_SMALL, N_SMALL, WIDTHS, "plain"),
             (2048, 1024, (40, 1, 7), "plain"),
             (1000, 2000, (40, 1, 7), "plain"),
             (N_MAIN, N_MAIN, (1, 16 * T_WIDE + 1), "plain"),
             (N_MAIN, N_MAIN, (), "residual count"),
             (4096, 4096, (9, 1), "zero_u"),
             (4096, 4096, (9, 1), "short_c")]
    max_err = 0
    for n, m, widths, kind in cases:
        pieces = _pieces(widths, n, dev, gen)
        if kind == "residual count":
            c, u = _residual_queries(n, dev, gen)
        else:
            c, u = _brackets(n, m, kind, dev, gen)
        outs, parents = resample_gather_split_u(pieces, c, u)
        torch.cuda.synchronize()
        ref_outs, ref_par = resample_gather_split_u_plain(pieces, c, u)
        torch.cuda.synchronize()
        max_err = max(max_err, _max_err(outs, ref_outs),
                      _max_err([parents], [ref_par]))
        if not torch.equal(parents, ref_par) or not all(
                torch.equal(o, r) for o, r in zip(outs, ref_outs)):
            raise AssertionError(f"G2 differs at n={n} m={m} {kind}")
        print(f"[3 G2] n={n} n_out={m} widths={widths} {kind}: "
              f"bit-equal to plain")
    return max_err


def _g4_inputs(n, m, kind, dev, gen):
    """G4's (c, u) at n and m: dirichlet brackets against sorted uniforms,
    with exact ties, residual's padding, all the mass on the first or the
    last particle, or every u equal to one c (so every u ties)."""
    c, u = _brackets(n, max(m, 1), "plain", dev, gen)
    u = u[:m].contiguous()
    if kind == "ties":   # exact ties u_j == c_i count (side='right')
        u[: m // 4] = c[torch.randint(0, n, (m // 4,), generator=gen,
                                      device=dev)]
        u = torch.sort(u).values
    elif kind == "padded":   # residual's padding of unused draws
        u[m // 2:] = 1.75
        u[m // 2 - 3:m // 2] = 1.5
    elif kind == "mass first":
        c = torch.ones(n, device=dev)
    elif kind == "mass last":
        c = torch.zeros(n, device=dev)
        c[-1] = 1.0
    elif kind == "equal u":
        u = c[n // 2].expand(m).contiguous()
    elif kind == "cumsum dips":   # the card's float32 cumsum, no cummax:
        # it dips by an ulp where its scan blocks meet (outside G4's
        # contract; the kernel counts for the running maximum of c)
        s = 2.0 - math.sqrt(D_VEC) * torch.randn(n, generator=gen,
                                                 device=dev)
        w = torch.softmax(-0.5 * s * s, 0)
        c = torch.cumsum(w, 0)
        c = c / c[-1]
    return c, u


G4_SKEWED = [(1_000_000, 1_000_000, "mass first"),
             (1_000_000, 1_000_000, "mass last"),
             (1_000_000, 1_000_000, "equal u"),
             (200_000, 800_000, "plain"), (800_000, 200_000, "plain")]


def _check_G4(dev, gen):
    from genparticlefilters_tpu_torch.ops.merge_count import (
        merge_count, merge_count_plain)
    cases = [(N_MAIN, N_MAIN, "plain"), (1_000_000, 1_000_000, "plain"),
             (N_MAIN, 60_000, "plain"), (30_000, N_MAIN, "plain"),
             (N_MAIN, N_MAIN, "ties"), (N_MAIN, N_MAIN, "padded"),
             (1_000_000, 1_000_000, "ties"),
             (1_000_000, 1_000_000, "padded"), *G4_SKEWED,
             (N_MAIN, N_MAIN, "mass last"), (1_000_000, 1, "plain"),
             (1, 1_000_000, "plain"), (1, 1, "plain"), (N_MAIN, 0, "plain")]
    max_err = 0
    for n, m, kind in cases:
        c, u = _g4_inputs(n, m, kind, dev, gen)
        F = merge_count(c, u)
        torch.cuda.synchronize()
        ref = merge_count_plain(c, u)
        torch.cuda.synchronize()
        max_err = max(max_err, _max_err([F], [ref]))
        if not torch.equal(F, ref):
            raise AssertionError(f"G4 differs at n={n} m={m} {kind}")
        print(f"[3 G4] n={n} m={m} {kind}: bit-equal to plain")
    for n in (500_000, 1_000_000):
        c, u = _g4_inputs(n, n, "cumsum dips", dev, gen)
        dips = int((c[1:] < c[:-1]).sum())
        F = merge_count(c, u)
        ref = torch.cummax(merge_count_plain(c, u), 0).values
        if not torch.equal(F, ref):
            raise AssertionError(f"G4 differs on a cumsum with {dips} dips: "
                                 f"{int((F != ref).sum())} counts")
        print(f"[3 G4] n=m={n}, c a card cumsum with {dips} one-ulp dips: "
              f"bit-equal to the cummax of plain (what _pinned_F makes of "
              f"either)")
    return max_err


def _g5_input(kind, dtype, shape, gen, dev):
    """``shape`` of ``dtype`` on the card: a card cumsum (float32 dips of
    an ulp where its blocks join), NaN planted at each row's start, middle
    and end, or signed zeros."""
    n = math.prod(shape)
    if kind == "cumsum":
        x = torch.cumsum(torch.rand(n, generator=gen, device=dev), 0)
        if dtype == torch.int32:
            x = (x * 4).to(torch.int32) - (torch.rand(
                n, generator=gen, device=dev) < 0.05).to(torch.int32)
    elif kind == "nan":
        x = torch.randn(n, generator=gen, device=dev)
        rows = x.view(-1, shape[-1])
        for at in (0, shape[-1] // 2, shape[-1] - 1):
            rows[:, at] = math.nan
    else:
        x = torch.tensor([0.0, -0.0, -1.0], device=dev)[torch.randint(
            0, 3, (n,), generator=gen, device=dev)]
    return x.to(dtype).reshape(shape)


def _check_G5(dev, gen):
    from genparticlefilters_tpu_torch.ops.max_scan import (max_scan,
                                                           max_scan_plain)
    shapes = [(n,) for n in (1, 33, 512, 513, 4095, 4096, 4097, N_MAIN,
                             N_MAIN + 1, 1_000_000)] + [(4, 250_000),
                                                        (1000, 100)]
    for dtype in (torch.int32, torch.float32):
        kinds = ("cumsum", "nan", "zeros") if dtype == torch.float32 \
            else ("cumsum",)
        for kind in kinds:
            for shape in shapes:
                x = _g5_input(kind, dtype, shape, gen, dev)
                got, ref = max_scan(x), max_scan_plain(x)
                torch.cuda.synchronize()
                if dtype == torch.float32:
                    got, ref = got.view(torch.int32), ref.view(torch.int32)
                if not torch.equal(got, ref):
                    raise AssertionError(f"G5 differs at {dtype} {shape} "
                                         f"{kind}")
            print(f"[3 G5] {dtype} {kind} at {len(shapes)} shapes "
                  f"(lengths 1 to 1M, [4, 250000], [1000, 100]): bit-equal "
                  f"to torch.cummax")
    return 0


ESS_SIZES = (1, 4097, N_MAIN, 500_000, 1_000_000)
ESS_KINDS = ("random", "degenerate", "uniform", "wide", "partly -inf",
             "nan", "all -inf", "+inf")


def _ess_input(kind, n, gen, dev):
    """``n`` float32 log weights of ``kind`` on the card: random, one
    dominant weight, all equal, wide (most exp terms underflow), a third
    at -inf, or with a NaN, all -inf, a +inf."""
    x = torch.randn(n, generator=gen, device=dev)
    if kind == "random":
        x = 2.0 * x
    elif kind == "degenerate":
        x[n // 3] += 60.0
    elif kind == "uniform":
        x = torch.full((n,), -3.25, device=dev)
    elif kind == "wide":
        x = 40.0 * x
    elif kind == "partly -inf":
        x[::3] = -math.inf
        x[n // 2] = 0.5
    elif kind == "nan":
        x[n // 2] = math.nan
    elif kind == "all -inf":
        x = torch.full((n,), -math.inf, device=dev)
    elif kind == "+inf":
        x[n // 4] = math.inf
    return x


def _ess_compare(lw, label):
    """The kernel against its plain version on ``lw`` at ess_frac 0, 0.25,
    0.5, 1 and 1.5 times N, at infinity and at the plain ESS times
    1 -/+ 1e-4: equal predicates (ess_frac 1 on equal weights included,
    where the ESS is N up to rounding), the ESS within 1e-5 relative of
    the chain's, NaN and false where the plain ESS is not finite. Returns
    the largest relative difference from the chain's ESS."""
    from genparticlefilters_tpu_torch.ops.ess_check import (ess_below,
                                                            ess_below_plain)
    n = lw.shape[0]
    pess = float(ess_below_plain(lw, 0.0, with_ess=True)[1])
    thrs = [f * n for f in (0.0, 0.25, 0.5, 1.0, 1.5)] + [math.inf]
    if math.isfinite(pess):
        thrs += [pess * (1 - 1e-4), pess * (1 + 1e-4)]
    err = 0.0
    for thr in thrs:
        low, ess = ess_below(lw, thr, with_ess=True)
        plow = ess_below_plain(lw, thr)
        e = float(ess)
        if not math.isfinite(pess):
            if not (math.isnan(e) and not bool(low) and not bool(plow)):
                raise AssertionError(f"ESS {label}: ESS {e} predicate "
                                     f"{bool(low)} where the chain's ESS is "
                                     f"{pess}")
            continue
        err = max(err, abs(e - pess) / pess)
        if bool(low) != bool(plow):
            raise AssertionError(f"ESS {label}: predicate {bool(low)} "
                                 f"against the chain's {bool(plow)} at "
                                 f"threshold {thr!r} (ESS {e!r}, chain "
                                 f"{pess!r})")
    if err > 1e-5:
        raise AssertionError(f"ESS {label}: relative difference {err:.3g} "
                             f"from the chain's ESS")
    return err


def _check_ess(dev, gen):
    err = 0.0

    def compare(lw, label):
        nonlocal err
        err = max(err, _ess_compare(lw, label))
    for kind in ESS_KINDS:
        for n in ESS_SIZES:
            compare(_ess_input(kind, n, gen, dev), f"{kind} N={n}")
        print(f"[3 ESS] {kind} at N = {', '.join(map(str, ESS_SIZES))}: "
              f"the predicate equal to the chain's at 8 thresholds; so far "
              f"the ESS within {err:.3g} relative of the chain's")
    for n in (5, 4097, 1_000_001):
        big = _ess_input("random", n + 3, gen, dev)
        for off in (1, 2, 3):
            compare(big[off:off + n], f"view +{off} N={n}")
    print(f"[3 ESS] views off a 16-byte boundary (N = 5, 4097, 1000001; "
          f"offsets 1-3): equal predicates; the ESS within {err:.3g} "
          f"relative of the chain's")
    return err


def _extreme_pieces(n, dev):
    """One row per extreme int32 bit pattern (0, -1, the int32 limits,
    small and 16-bit values, a float32 NaN, -0.0 and infinities)."""
    vals = [0, -1, 2**31 - 1, -2**31, 12345, -12345, 65536, -65536,
            0x7FC00000, 0x7F800000, -0x00800000]
    col = torch.tensor(vals, dtype=torch.int64).to(torch.int32)
    return [col[:, None].expand(len(vals), n).contiguous().to(dev)]


def _row_pieces(widths, n, dev, gen):
    return [torch.randint(-2**31, 2**31 - 1, (n, w), generator=gen,
                          device=dev, dtype=torch.int32) for w in widths]


def _offset_rows(n, w, offset, dev, gen):
    """An [n, w] piece viewed ``offset`` values into its storage: its
    address is off a 16-byte boundary unless 4 divides ``offset``."""
    flat = torch.randint(-2**31, 2**31 - 1, (offset + n * w,), generator=gen,
                         device=dev, dtype=torch.int32)
    return flat[offset:].view(n, w)


def _check_G3(dev, gen):
    """G3's largest error against plain: (column mode, row mode)."""
    from genparticlefilters_tpu_torch.ops.gather import (
        gather_cols, gather_cols_plain, gather_rows, gather_rows_plain,
        _vector_width)
    from genparticlefilters_tpu_torch.smc.resample import (
        systematic_F, _F_to_parents)

    def clustered(n, m):
        F = systematic_F(gen, _weights("dirichlet", n, dev, gen), n_out=m)
        return _F_to_parents(F, m)

    def perm(n):
        return torch.randperm(n, generator=gen, device=dev).to(torch.int32)

    def rows(widths, n):
        return lambda: _row_pieces(widths, n, dev, gen)
    n_wide = 16 * T_WIDE + 2
    cases = [  # (label, mode, pieces, parents)
        ("config-5 widths, clustered parents (systematic)", "cols",
         lambda: _pieces(WIDTHS_C5, N_C5, dev, gen),
         lambda: clustered(N_C5, N_C5)),
        ("arbitrary permutation", "cols",
         lambda: _pieces(WIDTHS_C5, N_MAIN, dev, gen), lambda: perm(N_MAIN)),
        ("all parents equal", "cols", lambda: _pieces((5, 1), 4096, dev, gen),
         lambda: torch.full((4096,), 4095, dtype=torch.int32, device=dev)),
        ("M = N/4", "cols", lambda: _pieces((40, 1, 7), 4096, dev, gen),
         lambda: clustered(4096, 1024)),
        ("M = 4N", "cols", lambda: _pieces((40, 1, 7), 1024, dev, gen),
         lambda: clustered(1024, 4096)),
        (f"width {n_wide}", "cols", lambda: _pieces((n_wide,), 8192, dev,
                                                      gen),
         lambda: clustered(8192, 8192)),
        ("extreme bit patterns", "cols", lambda: _extreme_pieces(4096, dev),
         lambda: perm(4096)),
        ("[N, 8], a permutation", "rows", rows((8,), N_MAIN),
         lambda: perm(N_MAIN)),
        ("[N, 1], clustered", "rows", rows((1,), N_MAIN),
         lambda: clustered(N_MAIN, N_MAIN)),
        ("widths 1, 3, 4, 8, 12, 16 in one call, a permutation", "rows",
         rows((1, 3, 4, 8, 12, 16), N_MAIN), lambda: perm(N_MAIN)),
        ("widths 1, 8, 16 at 1M, clustered", "rows", rows((1, 8, 16), N_C5),
         lambda: clustered(N_C5, N_C5)),
        ("[N, 8] and [N, 16] views 4 bytes off a 16-byte boundary", "rows",
         lambda: [_offset_rows(N_MAIN, 8, 1, dev, gen),
                  _offset_rows(N_MAIN, 16, 3, dev, gen)],
         lambda: perm(N_MAIN)),
        ("M = N/4", "rows", rows((8, 3), 4096),
         lambda: clustered(4096, 1024)),
        ("M = 4N", "rows", rows((8, 3), 1024), lambda: clustered(1024, 4096)),
        (f"width {n_wide}", "rows", rows((n_wide,), 8192),
         lambda: perm(8192)),
        ("extreme bit patterns", "rows",
         lambda: [p.T.contiguous() for p in _extreme_pieces(4096, dev)],
         lambda: perm(4096)),
    ]
    max_err = {"cols": 0, "rows": 0}
    for label, mode, make_pieces, make_parents in cases:
        pieces, parents = make_pieces(), make_parents()
        kern, plain = ((gather_cols, gather_cols_plain) if mode == "cols"
                       else (gather_rows, gather_rows_plain))
        outs = kern(pieces, parents)
        torch.cuda.synchronize()
        refs = plain(pieces, parents)
        torch.cuda.synchronize()
        max_err[mode] = max(max_err[mode], _max_err(outs, refs))
        if not all(torch.equal(o, r) for o, r in zip(outs, refs)):
            raise AssertionError(f"G3 differs: {mode} {label}")
        units = ("" if mode == "cols" else ", units " + str([
            _vector_width(p.shape[1], p.data_ptr(), o.data_ptr())
            for p, o in zip(pieces, outs)]))
        print(f"[3 G3] {mode} {label}: pieces "
              f"{[tuple(p.shape) for p in pieces]}, M={parents.shape[0]}"
              f"{units}: bit-equal to plain")
    return max_err["cols"], max_err["rows"]


TOY_FORMS = {
    # state as given (static inputs: every replaced leaf buffered, ELSE)
    "buffered": lambda x, k, z: (x, k, z),
    # state made in the run: every leaf donated, no ELSE body
    "donated": lambda x, k, z: (x * 1, k * 1, z * 1),
    # z, a static input the branch keeps, cannot be donated: an ELSE body
    # with nothing to copy
    "empty ELSE": lambda x, k, z: (x * 1, k * 1, z),
}
# (IF nodes with an ELSE body, donated leaves, buffered leaves)
TOY_WANT = {"buffered": (1, 0, 2), "donated": (0, 2, 0),
            "empty ELSE": (1, 2, 0)}


def _toy_cond(gen, pred, x, k, z, form="donated"):
    """One donating device_cond over a state of three [N_TOY] leaves, made
    from the inputs as ``TOY_FORMS[form]`` says, and a static one: the
    branch replaces x (drawing N_TOY uniforms) and k and keeps z; the run
    draws four more after it."""
    from genparticlefilters_tpu_torch import device_cond

    def branch(s):
        x_, k_, z_, tag = s
        return (x_ * 2 + torch.rand(x_.shape, generator=gen,
                                    device=x_.device), k_ + 3, z_, tag)
    out = device_cond(pred, branch, TOY_FORMS[form](x, k, z) + (7,),
                      donate=True)
    return out, torch.rand(4, generator=gen, device=x.device)


def _toy_runs(form):
    """(IF run, select run, their generators, the inputs): ``_toy_cond``
    in ``form`` captured as it ships, an IF node, and through capture's
    private ``_select_form`` as the select; each takes the predicate
    through its static input buffer."""
    from genparticlefilters_tpu_torch import capture
    g = _gen(3)
    inputs = (torch.tensor(True, device="cuda"),
              torch.randn(N_TOY, generator=g, device="cuda"),
              torch.randint(0, 1000, (N_TOY,), generator=g, device="cuda",
                            dtype=torch.int32),
              torch.randn(N_TOY, generator=g, device="cuda"))
    g_if, g_sel = _gen(0), _gen(0)
    run = capture(_toy_cond, g_if, *inputs, form=form)
    with _capture_module()._select_form():
        sel = capture(_toy_cond, g_sel, *inputs, form=form)
    return run, sel, g_if, g_sel, inputs


def _check_graph_cond():
    """The IF node against its plain version, in each toy form (one body;
    an ELSE body that copies; an ELSE body left empty): captured both
    ways, replayed with the predicate flipped through its input buffer,
    each replay bit-equal to the select's from the same seed; taken, both
    equal the eager run; untaken, the state comes back as it went in."""
    err = 0.0
    for form, want_forms in TOY_WANT.items():
        run, sel, g_if, g_sel, (_, x, k, z) = _toy_runs(form)
        forms = run.forms
        got = (forms["else_nodes"], forms["donated"], forms["buffered"])
        print(f"[3 graph_cond] toy form {form!r}: {run.nodes} IF node, "
              f"{got[0]} with an ELSE body, {got[1]} leaves donated, "
              f"{got[2]} buffered")
        if (run.nodes, sel.nodes) != (1, 0) or got != want_forms:
            raise AssertionError(
                f"graph_cond {form!r}: {run.nodes} IF nodes captured (want "
                f"1), {sel.nodes} in the select form, (ELSE nodes, donated, "
                f"buffered) {got} (want {want_forms})")
        for p in (True, False, False, True):
            pred = torch.tensor(p)
            g_if.manual_seed(5)
            a = run(pred)
            g_sel.manual_seed(5)
            b = sel(pred)
            want = (_toy_cond(_gen(5), pred.cuda(), x, k, z, form) if p
                    else ((x, k, z, 7), a[1]))
            torch.cuda.synchronize()
            err = max([err] + [float((u.double() - v.double()).abs().max())
                               for u, v in zip(a[0][:3], b[0][:3])])
            diff = _bit_equal(a, b) or _bit_equal(a, want)
            print(f"[3 graph_cond] {form!r}, predicate {p} through the "
                  f"input buffer, seed 5, state 3 x [{N_TOY}]: IF replay "
                  f"{'bit-equal' if diff is None else 'differs at ' + diff}"
                  f" to the select replay and to "
                  f"{'the eager run' if p else 'the incoming state'}")
            if diff is not None:
                raise AssertionError(f"graph_cond {form!r} differs: "
                                     f"predicate {p}, {diff}")
        _KEPT.extend((run, sel))
    return err


def _leaf_set(n, dev, gen):
    """The 8 leaves the headline's ESS branch replaces at N = n: the
    [40, n] int32 store, three [n] float32, an [n] bool, an [n] int32, a
    [10] float32 and a float32 scalar (177 bytes per particle)."""
    shapes = ([((40, n), torch.int32)] + [((n,), torch.float32)] * 3
              + [((n,), torch.bool), ((n,), torch.int32),
                 ((10,), torch.float32), ((), torch.float32)])
    return [torch.rand(shape, generator=gen, device=dev) < 0.5
            if dtype == torch.bool else
            torch.randint(-2**31, 2**31 - 1, shape, generator=gen,
                          device=dev, dtype=torch.int32).view(dtype)
            for shape, dtype in shapes]


def _bytes(t):
    return t.reshape(-1).view(torch.uint8)


def _copy_cases(dev, gen):
    """(label, srcs) for copy_leaves: the headline's leaf set at 100K and
    1M; views off a 16-byte boundary (4-, 2- and 1-byte units) and odd
    byte counts; 130 small leaves (two launches); an empty leaf."""
    big = torch.randint(-2**31, 2**31 - 1, (1 << 20,), generator=gen,
                        device=dev, dtype=torch.int32)
    odd = [big[1:100_001], big.view(torch.int16)[1:200_003],
           big.view(torch.uint8)[3:300_004], big.view(torch.uint8)[:13],
           big.view(torch.int64)[1:50_001], big[:0]]
    many = [torch.randn(i + 1, generator=gen, device=dev)
            for i in range(130)]
    return [(f"headline leaf set N={n}", _leaf_set(n, dev, gen))
            for n in (N_MAIN, 1_000_000)] + [
        ("misaligned views and odd sizes", odd), ("130 leaves", many)]


def _check_copy_leaves(dev, gen):
    """copy_leaves against copy_leaves_plain on each case, bit for bit
    (byte views compared), with its launches counted, by the wrapper and
    by the kernel's own counter on the card."""
    from genparticlefilters_tpu_torch.ops.graph_cond import (
        copy_leaves, copy_leaves_plain, copy_leaves_runs)
    copy_leaves_runs(reset=True)
    first = copy_leaves.launches
    for label, srcs in _copy_cases(dev, gen):
        got = [torch.empty_like(s) for s in srcs]
        want = [torch.empty_like(s) for s in srcs]
        for t in got + want:
            _bytes(t).fill_(0xA5)
        before = copy_leaves.launches
        copy_leaves(got, srcs)
        copy_leaves_plain(want, srcs)
        torch.cuda.synchronize()
        same = all(torch.equal(_bytes(a), _bytes(b))
                   for a, b in zip(got, want))
        nbytes = sum(s.numel() * s.element_size() for s in srcs)
        print(f"[3 copy_leaves] {label}: {len(srcs)} leaves, "
              f"{nbytes / 1e6:.3f} MB, {copy_leaves.launches - before} "
              f"launches: {'bit-equal' if same else 'DIFFERS'} to the "
              f"plain version")
        if not same:
            raise AssertionError(f"copy_leaves differs on {label}")
    launched, ran = copy_leaves.launches - first, copy_leaves_runs()
    print(f"[3 copy_leaves] launches counted by the wrapper {launched}, "
          f"runs counted by the kernel on the card {ran}")
    if ran != launched:
        raise AssertionError(f"copy_leaves: {launched} launches, {ran} "
                             f"runs counted on the card")
    return 0.0


def phase_kernel_vs_plain():
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    torch.manual_seed(0)
    return dict(zip(KERNELS, (_check_G1(dev, gen), _check_G2(dev, gen),
                              *_check_G3(dev, gen), _check_G4(dev, gen),
                              _check_G5(dev, gen), _check_graph_cond(),
                              _check_copy_leaves(dev, gen),
                              _check_ess(dev, gen))))


def _data():
    from genparticlefilters_tpu_torch.models.object_motion import (
        synthesize_data)
    y_obs, _ = synthesize_data(
        torch.Generator(device="cuda").manual_seed(42), T_MAIN, SWITCH)
    return y_obs


def _stratified_unsorted_filter(gen, y_obs, n, t_max):
    """The README filter loop of ``object_motion_filter`` with unsorted
    stratified resampling (the method's default sorts by weight)."""
    import genparticlefilters_tpu_torch as g
    from genparticlefilters_tpu_torch.models.object_motion import (
        make_object_motion, init_state, obs_dense)
    dev = gen.device
    model, x0, obs = make_object_motion(t_max), init_state(dev), obs_dense(
        y_obs)
    state = g.pf_initialize(gen, model, (1, x0), obs, n)
    steps = torch.arange(t_max, device=dev)
    for t in range(1, t_max):
        if bool(g.effective_sample_size(state) < 0.5 * n):
            state = g.pf_stratified_resample(gen, state, check=False,
                                             sort_particles=False)
            m = (steps == t - 1) | (steps == t)
            sel = g.Selection({("moving",): m, ("y",): m})
            state = g.pf_rejuvenate(gen, state, g.mh, (sel,), window=2)
        state = g.pf_update(gen, state, (t + 1, x0),
                            (g.Extend(1), g.NoChange()), obs, check=False)
    return state


def _filter(method):
    """``(gen, y_obs, n) -> state`` for a resampling method name."""
    from genparticlefilters_tpu_torch.models.object_motion import (
        object_motion_filter)
    if method == "stratified (unsorted)":
        return lambda gen, y, n: _stratified_unsorted_filter(gen, y, n,
                                                             T_MAIN)
    return lambda gen, y, n: object_motion_filter(gen, y, n, T_MAIN,
                                                  resample_method=method)


def _posterior_check(run, y_obs, n, label, seeds=4, k_se=6.0,
                     lml_se=False):
    """The filter's P(moving@t) over ``seeds`` seeds within
    k_se·stderr + 0.03 of exact enumeration, and the mean LML within 0.2
    of the exact value (plus 6 LML stderrs where ``lml_se``)."""
    import genparticlefilters_tpu_torch as g
    from genparticlefilters_tpu_torch.models.object_motion import (
        exact_posterior)
    post, exact_lml = exact_posterior(y_obs.cpu().numpy())
    res, lmls = [], []
    for s in range(seeds):
        st = run(torch.Generator(device="cuda").manual_seed(200 + s), y_obs,
                 n)
        res.append([float(g.mean(st, (t, "moving")))
                    for t in range(T_MAIN)])
        lmls.append(float(g.log_ml_estimate(st)))
    res = np.array(res)
    est = res.mean(0)
    stderr = res.std(0) / math.sqrt(len(res)) + 1e-3
    if float(np.max(np.abs(est - post) - (k_se * stderr + 0.03))) >= 0:
        raise AssertionError(f"{label}: posterior off: est {est} exact "
                             f"{post}")
    lml_lim = 0.2 + (6 * np.std(lmls) / math.sqrt(seeds) if lml_se else 0)
    if abs(np.mean(lmls) - exact_lml) >= lml_lim:
        raise AssertionError(f"{label}: LML {np.mean(lmls)} vs exact "
                             f"{exact_lml}")
    print(f"[{label} posterior] {seeds} seeds at N={n}: P(moving@t) max "
          f"|est-exact| {float(np.max(np.abs(est - post))):.4f} (limit "
          f"{k_se:g}*stderr+0.03), mean LML {np.mean(lmls):.4f} vs exact "
          f"{exact_lml:.4f} (limit {lml_lim:.3f})")


def phase_main_path(y_obs):
    import genparticlefilters_tpu_torch as g
    from genparticlefilters_tpu_torch.models.object_motion import (
        object_motion_filter)
    _reset_counts()
    st = object_motion_filter(torch.Generator(device="cuda").manual_seed(100),
                              y_obs, N_MAIN, T_MAIN,
                              resample_method="systematic")
    torch.cuda.synchronize()
    counts = _counts()
    missing = [k for k in (G1, ESS) if counts[k] < 1]
    if missing:
        raise AssertionError(f"the main path never launched {missing}")
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
          f"on cuda: launches {_short(counts)}, LML {lml:.4f}, "
          f"mat {tuple(store.mat.shape)} int32 on cuda")
    _posterior_check(_filter("systematic"), y_obs, N_MAIN, "4")
    return counts, st


def _path(label, run, need):
    """Run ``run()`` with every launch count at 0; every kernel in ``need``
    must have launched. Returns (result, counts)."""
    _reset_counts()
    out = run()
    torch.cuda.synchronize()
    counts = _counts()
    missing = [k for k in need if counts[k] < 1]
    if missing:
        raise AssertionError(f"path {label} never launched {missing}")
    print(f"[{label}] launches {_short(counts)}")
    return out, counts


def phase_paths(y_obs, main_state):
    """Paths (a)-(n); returns the launch counts of each."""
    seen = {}
    gen = lambda s: torch.Generator(device="cuda").manual_seed(s)  # noqa
    st, seen["4a"] = _path(
        "4a residual N=100K",
        lambda: _filter("residual")(gen(100), y_obs, N_MAIN),
        (G1, G2, G5, ESS))
    _posterior_check(_filter("residual"), y_obs, N_MAIN, "4a")
    _, seen["4b"] = _path(
        "4b residual N=100",
        lambda: _filter("residual")(gen(101), y_obs, N_SMALL), (G1, G2))
    # N=100 over few seeds: the Monte Carlo error dominates, so the stderr
    # terms widen (16 seeds, 8 stderrs, and LML stderrs); the 0.03 stays
    _posterior_check(_filter("residual"), y_obs, N_SMALL, "4b", seeds=16,
                     k_se=8.0, lml_se=True)
    for method in ("multinomial", "stratified (unsorted)"):
        _, seen[f"4c {method}"] = _path(
            f"4c {method} N=100K",
            lambda: _filter(method)(gen(102), y_obs, N_MAIN), (G2,))
        _posterior_check(_filter(method), y_obs, N_MAIN, "4c")
    seen["4d"] = _substate_path(st)
    _resample_sync_check(st)
    seen["4e"] = _lg_path()
    del st
    seen.update(_config5_paths())
    seen.update(_config34_paths(y_obs, main_state))
    seen.update(_call_site_paths())
    seen.update(_per_particle_paths(y_obs))
    seen.update(_nested_paths())
    return seen


def _synced(fn):
    """(fn's result, the synchronizing CUDA calls flagged while it ran)."""
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        out = fn()
    torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    fallbacks = [str(w.message)[:160] for w in rec
                 if "performance drop" in str(w.message)]
    if fallbacks:
        raise AssertionError(f"an op ran vmap's per-element fallback: "
                             f"{fallbacks}")
    return out, [f"{w.filename}:{w.lineno}" for w in rec
                 if "synchroniz" in str(w.message)]


def _resample_sync_check(state):
    """No resample of a state or sub-state waits for the device: the
    flagged synchronizing calls of one pf_resample must be none."""
    import genparticlefilters_tpu_torch as g
    gen = torch.Generator(device="cuda").manual_seed(600)
    cases = [(m, state) for m in ("multinomial", "residual", "stratified",
                                  "systematic")]
    cases += [(m, state[0:N_MAIN // 2]) for m in ("multinomial",
                                                  "residual")]
    for method, s in cases:
        _, syncs = _synced(lambda: g.pf_resample(gen, s, method,
                                                 check=False))
        if syncs:
            raise AssertionError(f"pf_resample {method} on {s!r} synced the "
                                 f"host: {syncs}")
    print(f"[4d syncs] pf_resample of the N={N_MAIN} state (4 methods) and "
          f"of a half (multinomial, residual): no synchronizing CUDA call "
          f"flagged (torch.cuda.set_sync_debug_mode)")


def _substate_path(state):
    """Sub-state resampling of the two halves of a N=100K filter state."""
    import genparticlefilters_tpu_torch as g
    from genparticlefilters_tpu_torch.core.batching import tree_take
    from genparticlefilters_tpu_torch.core.tree import tree_leaves
    half = N_MAIN // 2
    lml0 = float(g.log_ml_estimate(state))
    total = {k: 0 for k in KERNELS}
    for method in ("multinomial", "residual"):
        def run():
            s = state
            errs = []
            for i, blk in enumerate((slice(0, half), slice(half, N_MAIN))):
                sub_lml = float(g.log_ml_estimate(s[blk]))
                s = g.pf_resample(torch.Generator(device="cuda").manual_seed(
                    500 + i), s[blk], method, check=False)
                errs.append(abs(float(g.log_ml_estimate(s[blk])) - sub_lml))
                par = s.parents[blk]
                if int(par.min()) < blk.start or int(par.max()) >= blk.stop:
                    raise AssertionError(f"4d {method}: parents leave "
                                         f"block {blk}")
            return s, errs
        (s, errs), counts = _path(f"4d sub-states {method}", run, (G4,))
        for k in total:
            total[k] += counts[k]
        glob = abs(float(g.log_ml_estimate(s)) - lml0)
        if max(errs) >= 1e-3 or glob >= 1e-3:
            raise AssertionError(f"4d {method}: block LML moved {errs}, "
                                 f"global {glob}")
        gathered = tree_take(state.traces, s.parents)
        if not all(torch.equal(a, b) for a, b in zip(
                tree_leaves(gathered), tree_leaves(s.traces))
                if isinstance(a, torch.Tensor)):
            raise AssertionError(f"4d {method}: ancestry broken")
        print(f"[4d {method}] two halves of N={N_MAIN}: block LML moved "
              f"{max(errs):.2e}, global {glob:.2e} (limit 1e-3); parents "
              f"inside their block; traces == old traces[parents]")
    return total


N_LG, T_LG = 10_000, 8          # config 2 (BASELINE.json)


def _lg_setup():
    """(LGParams, y [T_LG] drawn from the model, the Kalman filter's
    (means, variances, log Z) of y)."""
    from genparticlefilters_tpu_torch.models.linear_gaussian import (
        LGParams, synthesize_lg_data, kalman_filter)
    p = LGParams()
    y = synthesize_lg_data(_gen(0), T_LG, p)
    return p, y, kalman_filter(y.cpu().numpy(), p)


def _lg_gate(label, sts, kalman):
    """Four filter states against the Kalman filter, with the tolerances
    of tests/test_models.py: the mean and LML of the first three, the
    variance of the fourth."""
    import genparticlefilters_tpu_torch as g
    mus, vars_, lml_exact = kalman
    sd = math.sqrt(float(vars_[-1]))
    est = np.mean([float(g.mean(s, (T_LG - 1, "x"))) for s in sts[:3]])
    lml = np.mean([float(g.log_ml_estimate(s)) for s in sts[:3]])
    var = float(g.var(sts[3], (T_LG - 1, "x")))
    if (abs(est - mus[-1]) >= 0.05 * sd + 0.02
            or abs(lml - lml_exact) >= 0.05
            or abs(var - vars_[-1]) >= 0.2 * vars_[-1]):
        raise AssertionError(f"{label}: mean {est} vs {mus[-1]}, LML {lml} "
                             f"vs {lml_exact}, var {var} vs {vars_[-1]}")
    print(f"[{label}] N={N_LG} T={T_LG}: filtering mean {est:.4f} vs "
          f"Kalman {mus[-1]:.4f} (limit {0.05 * sd + 0.02:.4f}), LML "
          f"{lml:.4f} vs {lml_exact:.4f} (limit 0.05), var {var:.4f} vs "
          f"{vars_[-1]:.4f} (rtol 0.2)")


def _lg_path():
    """The linear-Gaussian filter (BASELINE config 2) against the Kalman
    filter."""
    from genparticlefilters_tpu_torch.models.linear_gaussian import (
        lgssm_particle_filter)
    p, y, kalman = _lg_setup()
    total = {k: 0 for k in KERNELS}
    for method in ("systematic", "stratified"):
        def run():
            return [lgssm_particle_filter(_gen(10 + s), y, N_LG, T_LG, p,
                                          method) for s in range(4)]
        sts, counts = _path(f"4e linear-Gaussian {method}", run, ())
        for k in total:
            total[k] += counts[k]
        _lg_gate(f"4e {method}", sts, kalman)
    return total


def _mot_data(t_max, seed=5):
    from genparticlefilters_tpu_torch.models.multi_object import (
        MOTParams, synthesize_mot_data)
    return synthesize_mot_data(torch.Generator(device="cuda").manual_seed(
        seed), t_max, MOTParams())


def _c5_run(gen, y, n, t_max=T_C5, lmls=None):
    """Config 5 on the resize schedule of scripts/config45_bench.py:
    systematic resampling when ESS < n_now/2 and one-step extensions, a
    residual resize to n/2 before step T//3 and a multinomial resize back
    to n before step 2T//3. With ``lmls`` (a list), each resize appends
    ``(label, LML before, LML after)`` (host reads: check runs only)."""
    import genparticlefilters_tpu_torch as g
    from genparticlefilters_tpu_torch.models.multi_object import (
        MOTParams, make_mot_model, mot_obs_dense)
    from torch.profiler import record_function
    p = MOTParams()
    x0 = torch.zeros((p.n_objects, 2), dtype=torch.float32, device="cuda")
    obs = mot_obs_dense(y)
    with record_function("c5.initialize"):
        st = g.pf_initialize(gen, make_mot_model(t_max, p), (1, x0), obs, n)
    n_now = n
    for t in range(1, t_max):
        for when, method, size in ((t_max // 3, "residual", n // 2),
                                   (2 * t_max // 3, "multinomial", n)):
            if t == when:
                before = st
                with record_function("c5.resize"):
                    st = g.pf_resize(gen, st, size, method, check=False)
                n_now = size
                if lmls is not None:
                    lmls.append((f"{method} {before.n_particles}->{size}",
                                 float(g.log_ml_estimate(before)),
                                 float(g.log_ml_estimate(st))))
        with record_function("c5.ess_check"):
            low = bool(g.effective_sample_size(st) < 0.5 * n_now)
        if low:
            with record_function("c5.resample"):
                st = g.pf_resample(gen, st, "systematic", check=False)
        with record_function("c5.update"):
            st = g.pf_update(gen, st, (t + 1, x0),
                             (g.Extend(1), g.NoChange()), obs, check=False)
    return st


def _mot_posterior_check(label, st, y, t_max):
    """The posterior mean of every object's position at the last step lies
    within 3 observation sds of the last observation."""
    import genparticlefilters_tpu_torch as g
    from genparticlefilters_tpu_torch.models.multi_object import MOTParams
    r = MOTParams().r
    x_mean = g.mean(st, (t_max - 1, "x"))
    err = float((x_mean - y[t_max - 1]).abs().max())
    if not (math.isfinite(err) and err < 3 * r):
        raise AssertionError(f"{label}: posterior mean {x_mean} vs last "
                             f"observation {y[t_max - 1]}")
    return err


def _ancestry_ok(old, new):
    from genparticlefilters_tpu_torch.core.batching import tree_take
    from genparticlefilters_tpu_torch.core.tree import tree_leaves
    return all(torch.equal(a, b) for a, b in zip(
        tree_leaves(tree_take(old.traces, new.parents)),
        tree_leaves(new.traces)) if isinstance(a, torch.Tensor))


@contextlib.contextmanager
def _row_mode_leaves():
    """Record what ``_gather_traces`` hands to G3's row mode while the block
    runs: one ``(widths, N, M)`` per call that has pieces."""
    from genparticlefilters_tpu_torch.smc import resample
    inner = resample.gather_rows
    calls = []

    def recorder(pieces, parents):
        pieces = list(pieces)
        if pieces:
            calls.append((tuple(p.shape[1] for p in pieces),
                          pieces[0].shape[0], parents.shape[0]))
        return inner(pieces, parents)
    resample.gather_rows = recorder
    try:
        yield calls
    finally:
        resample.gather_rows = inner


def _print_row_leaves(label, calls):
    widths = sorted({w for ws, _, _ in calls for w in ws})
    print(f"[{label} row mode] particle-first leaves of rank >= 2 handed to "
          f"G3's row mode: {len(calls)} calls, widths {widths}"
          + ("" if calls else " (every leaf of this state is particle-last: "
             "the packed store and the score)"))


def _config5_path(y):
    """(f): config 5 at N=1M on the resize schedule, then optimal resize to
    N/4, replicate x4 and dereplicate; returns the filter's final state."""
    import genparticlefilters_tpu_torch as g
    gen = torch.Generator(device="cuda").manual_seed(500)
    lmls = []

    def run():
        st = _c5_run(gen, y, N_C5, lmls=lmls)
        opt = g.pf_resize(gen, st, N_C5 // 4, "optimal", check=False)
        rep = g.pf_replicate(opt, 4)
        der = g.pf_dereplicate(gen, rep, 4, method="keepfirst")
        return st, opt, rep, der
    with _row_mode_leaves() as calls:
        (st, opt, rep, der), counts = _path(f"4f config 5 N={N_C5}", run, ())
    _print_row_leaves("4f", calls)
    need = {G1: 1, G2: 2, G3: 3}
    if any(counts[k] < v for k, v in need.items()):
        raise AssertionError(f"4f launches {counts}, need at least {need}")
    err = _mot_posterior_check("4f", st, y, T_C5)
    lml = float(g.log_ml_estimate(st))
    lmls.append((f"optimal {N_C5}->{N_C5 // 4}", lml,
                 float(g.log_ml_estimate(opt))))
    bad = [x for x in lmls if abs(x[1] - x[2]) >= 1e-3]
    if bad:
        raise AssertionError(f"4f: a resize moved the LML: {bad}")
    lml_opt = g.log_ml_estimate(opt)
    lml_rep = g.log_ml_estimate(rep)
    if not torch.equal(g.log_ml_estimate(der), lml_opt) or not torch.equal(
            der.log_weights, opt.log_weights):
        raise AssertionError("4f: dereplicate(replicate(s)) changed the "
                             "weights or the LML")
    if abs(float(lml_rep) - float(lml_opt)) >= 1e-5 * abs(float(lml_opt)):
        raise AssertionError(f"4f: replicate moved the LML: {lml_rep} vs "
                             f"{lml_opt}")
    if torch.unique(opt.parents).numel() != N_C5 // 4:
        raise AssertionError("4f: optimal-resize parents are not unique")
    if not (_ancestry_ok(st, opt) and _ancestry_ok(opt, rep)
            and _ancestry_ok(rep, der)):
        raise AssertionError("4f: traces != old traces[parents]")
    print(f"[4f config 5] N={N_C5} T={T_C5} K=4: posterior mean max "
          f"|x - y_last| {err:.4f} (limit 3r = 1.5); LML before -> after "
          f"each resize {[(a, round(b, 5), round(c, 5)) for a, b, c in lmls]}"
          f" (limit 1e-3); replicate LML {float(lml_rep):.6f} vs "
          f"{float(lml_opt):.6f} (rtol 1e-5), dereplicate(keepfirst) "
          f"restores weights and LML bit for bit; optimal-resize parents "
          f"unique; traces == old traces[parents] after every verb")
    return st, counts


def _wide_pack_path():
    """(g): T=64, 1025 packed rows: multinomial at N=100K (G2 over the wide
    pieces) and systematic at N=1000 (G1)."""
    from genparticlefilters_tpu_torch.models.multi_object import (
        MOTParams, mot_particle_filter)
    y = _mot_data(T_WIDE, seed=6)
    total = {k: 0 for k in KERNELS}
    for method, n, need in (("multinomial", N_MAIN, G2),
                            ("systematic", 1000, G1)):
        st, counts = _path(
            f"4g wide pack T={T_WIDE} {method} N={n}",
            lambda: mot_particle_filter(
                torch.Generator(device="cuda").manual_seed(501), y, n,
                T_WIDE, MOTParams(), resample_method=method), (need,))
        for k in total:
            total[k] += counts[k]
        rows = 1 + st.traces.inner["store"].mat.shape[0]
        err = _mot_posterior_check("4g", st, y, T_WIDE)
        print(f"[4g {method} N={n}] {rows} packed rows (past 1022); "
              f"posterior mean max |x - y_last| {err:.4f} (limit 1.5)")
    return total


def _blockwise_path(state):
    """(h): blockwise resampling of the config-5 state in 4 blocks, then
    block rotation and shuffle."""
    import genparticlefilters_tpu_torch as g
    K = 4
    n = state.n_particles
    b = n // K
    lml0 = g.log_ml_estimate(state)
    tot0 = torch.logsumexp(state.log_weights.reshape(K, b), 1)
    total = {k: 0 for k in KERNELS}
    gen = torch.Generator(device="cuda").manual_seed(502)
    calls = []
    cases = [("systematic", None, G1), ("residual", None, G1),
             ("multinomial", None, G2), ("stratified", False, G2),
             ("stratified", True, G3)]
    for method, sort, need in cases:
        label = method + ("" if sort is None else
                          " sorted" if sort else " unsorted")
        with _row_mode_leaves() as rec:
            out, counts = _path(
                f"4h blockwise {label} K={K}",
                lambda: g.pf_resample_blockwise(gen, state, K, method,
                                                sort_particles=sort), (need,))
        calls += rec
        for k in total:
            total[k] += counts[k]
        moved = float((torch.logsumexp(out.log_weights.reshape(K, b), 1)
                       - tot0).abs().max())
        blk = out.parents.reshape(K, b).long() // b
        inside = bool((blk == torch.arange(K, device="cuda")[:, None]).all())
        if (moved >= 1e-3 or not inside
                or not torch.equal(out.log_ml_est, state.log_ml_est)
                or not _ancestry_ok(state, out)):
            raise AssertionError(f"4h {label}: block totals moved {moved}, "
                                 f"parents inside blocks {inside}")
        print(f"[4h {label}] block totals moved {moved:.2e} (limit 1e-3); "
              f"global LML untouched; parents inside their block")
    for label, op in (("rotate", lambda: g.pf_rotate_blocks(state, K, 1)),
                      ("shuffle", lambda: g.pf_shuffle_blocks(state, K))):
        with _row_mode_leaves() as rec:
            out, counts = _path(f"4h {label} K={K}", op, (G3,))
        calls += rec
        for k in total:
            total[k] += counts[k]
        # the LML is a sum over a permuted vector: equal up to float32
        # summation order
        d_lml = abs(float(g.log_ml_estimate(out)) - float(lml0))
        if not (torch.equal(out.log_weights,
                            state.log_weights[out.parents.long()])
                and _ancestry_ok(state, out) and d_lml < 1e-4):
            raise AssertionError(f"4h {label}: weights and traces moved "
                                 f"apart, or the LML moved {d_lml}")
        print(f"[4h {label}] weights move with their traces; LML moved "
              f"{d_lml:.2e} (limit 1e-4)")
    _print_row_leaves("4h", calls)
    return total


def _mot_da_path():
    """(i): the data-association model at N=100K, K=3, T=5, with the
    association recovered at every slot of the last step."""
    import genparticlefilters_tpu_torch as g
    from genparticlefilters_tpu_torch.models.multi_object import (
        MOTParams, mot_da_particle_filter)
    p = MOTParams(n_objects=3, q=0.05, r=0.1, s0=0.5)
    T = 5
    rng = np.random.default_rng(7)
    x_true = torch.tensor([[-4.0, 0.0], [0.0, 4.0], [4.0, -4.0]])
    perms = np.stack([rng.permutation(3) for _ in range(T)])
    y = (x_true[torch.from_numpy(perms)] + 0.05 * torch.from_numpy(
        rng.normal(size=(T, 3, 2)).astype(np.float32))).cuda()
    st, counts = _path("4i MOT-DA N=100K", lambda: mot_da_particle_filter(
        torch.Generator(device="cuda").manual_seed(503), y, N_MAIN, T, p,
        0.5, x_true.cuda()), ())
    assoc = g.batched_choice(st, (T - 1, "assoc"))
    w = g.get_norm_weights(st)
    got = [int(torch.argmax(torch.stack([w[assoc[:, j] == o].sum()
                                         for o in range(3)])))
           for j in range(3)]
    if got != [int(v) for v in perms[T - 1]]:
        raise AssertionError(f"4i: associations {got}, truth "
                             f"{perms[T - 1]}")
    print(f"[4i MOT-DA] N={N_MAIN} K=3 T={T}: posterior-mode associations "
          f"{got} == truth")
    return counts


def _vector_model():
    """A model with an 8-wide vector site: x ~ N(0, I_8), y ~ N(sum(x),
    1). Its x site and return value are [N, 8] leaves, particle axis
    first."""
    from genparticlefilters_tpu_torch.core import gen, trace, normal

    @gen
    def vector_site(mu):
        x = trace("x", normal(mu, 1.0))
        trace("y", normal(x.sum(-1), 1.0))
        return x
    vector_site.batch_safe = True
    return vector_site


def _vector_site_path():
    """(j): the vector-site model at N=1M observed at y = 2: sorted
    stratified resampling, sub-state resampling of the two halves
    (multinomial, G4), optimal resize to N/4 and block rotation (K=4),
    each moving the [N, 8] leaves through G3's row mode; the posterior mean
    of sum(x) against its exact value 8y/9, the LML against log N(y; 0,
    9), and the ancestry of every result."""
    import genparticlefilters_tpu_torch as g
    gen = torch.Generator(device="cuda").manual_seed(504)
    obs = g.ChoiceMap({("y",): g.Entry(torch.tensor(Y_VEC, device="cuda"),
                                       True)})
    st = g.pf_initialize(gen, _vector_model(),
                         (torch.zeros(D_VEC, device="cuda"),), obs, N_VEC)
    exact_mean = D_VEC / (D_VEC + 1) * Y_VEC
    exact_lml = (-0.5 * math.log(2 * math.pi * (D_VEC + 1))
                 - Y_VEC ** 2 / (2 * (D_VEC + 1)))
    half = N_VEC // 2

    def run():
        s = st
        for blk in (slice(0, half), slice(half, N_VEC)):
            s = g.pf_resample(gen, s[blk], "multinomial", check=False)
        return {"sorted stratified": g.pf_resample(gen, st, "stratified",
                                                   check=False),
                "sub-states multinomial": s,
                "optimal resize N/4": g.pf_resize(gen, st, N_VEC // 4,
                                                  "optimal", check=False),
                "rotate K=4": g.pf_rotate_blocks(st, 4, 1)}
    with _row_mode_leaves() as calls:
        outs, counts = _path(f"4j vector site N={N_VEC}", run, (G3R, G4))
    _print_row_leaves("4j", calls)
    lml = float(g.log_ml_estimate(st))
    for label, s in [("initialized", st)] + list(outs.items()):
        err = abs(float(g.mean(s, ("x",)).sum()) - exact_mean)
        d_lml = abs(float(g.log_ml_estimate(s)) - lml)
        if err >= 0.02 or d_lml >= 1e-3 or (
                s is not st and not _ancestry_ok(st, s)):
            raise AssertionError(f"4j {label}: posterior mean of sum(x) off "
                                 f"by {err}, LML moved {d_lml}, or traces "
                                 f"!= old traces[parents]")
        print(f"[4j {label}] N={s.n_particles}: posterior mean of sum(x) "
              f"within {err:.4f} of 8y/9 (limit 0.02); LML moved "
              f"{d_lml:.2e} (limit 1e-3)"
              + ("" if s is st else "; traces == old traces[parents]"))
    par = outs["sub-states multinomial"].parents.long()
    if (par[:half].max() >= half or par[half:].min() < half
            or abs(lml - exact_lml) >= 0.02):
        raise AssertionError(f"4j: sub-state parents leave their half, or "
                             f"LML {lml} vs exact {exact_lml}")
    print(f"[4j] LML {lml:.5f} vs exact {exact_lml:.5f} (limit 0.02); "
          f"sub-state parents inside their half")
    return counts


def _config5_paths():
    """Paths (f)-(j); returns the launch counts of each."""
    y = _mot_data(T_C5)
    st, c5 = _config5_path(y)
    return {"4f": c5, "4g": _wide_pack_path(), "4h": _blockwise_path(st),
            "4i": _mot_da_path(), "4j": _vector_site_path()}


# ---------------------------------------------------------------------------
# Configs 3 and 4, strata and views (paths 4k-4n)
# ---------------------------------------------------------------------------

def _gen(seed):
    return torch.Generator(device="cuda").manual_seed(seed)


def _sv_setup():
    """(SVParams, y [T_SV] drawn from the model, the filter as
    ``run(gen, y, n)``)."""
    from genparticlefilters_tpu_torch.models.stochastic_volatility import (
        SVParams, synthesize_sv_data, sv_particle_filter)
    p = SVParams()
    y = synthesize_sv_data(_gen(8), T_SV, p)
    return p, y, lambda gen, y_, n: sv_particle_filter(gen, y_, n, T_SV, p,
                                                       rejuv_window=2)


def _sv_bootstrap_lml(y, n, p, seed):
    """An independent bootstrap filter of the SV model (no package code):
    propagate from the prior, weigh by N(y_t; 0, exp(h_t/2)), resample
    systematically every step; its LML estimate in float64."""
    gen = _gen(seed)
    dev = y.device
    steps = torch.arange(n, device=dev, dtype=torch.float64)
    h = p.mu + p.sigma / math.sqrt(1 - p.phi ** 2) * torch.randn(
        n, generator=gen, device=dev)
    lml = torch.zeros((), dtype=torch.float64, device=dev)
    for t in range(y.shape[0]):
        if t > 0:
            h = p.mu + p.phi * (h - p.mu) + p.sigma * torch.randn(
                n, generator=gen, device=dev)
        hd = h.double()
        lw = (-0.5 * y[t].double() ** 2 * torch.exp(-hd) - 0.5 * hd
              - 0.5 * math.log(2 * math.pi))
        lml = lml + torch.logsumexp(lw, 0) - math.log(n)
        c = torch.cumsum(torch.softmax(lw, 0), 0)
        u = (torch.rand((), generator=gen, device=dev, dtype=torch.float64)
             + steps) / n
        h = h[torch.clamp_max(torch.searchsorted(c, u), n - 1)]
    return float(lml)


def _zero_weight_check():
    """No resampling route picks a particle of weight 0: nine in ten of
    1M weights are exactly 0 (a float32 scan of the weights picked such
    particles on the card, where its blocks join)."""
    from genparticlefilters_tpu_torch.ops.fused_gather import (
        resample_gather_split, resample_gather_split_u)
    from genparticlefilters_tpu_torch.smc import resample as R
    n = 1_000_000
    gen = _gen(805)
    w = torch.distributions.Gamma(torch.full((n,), 0.3, device="cuda"),
                                  1.0).sample()
    w = w * (torch.rand(n, generator=gen, device="cuda") < 0.1)
    w = (w / w.sum()).to(torch.float32)
    routes = {
        "systematic (G1)": lambda: resample_gather_split(
            [], R.systematic_F(gen, w))[1],
        "residual (G2 count, G1)": lambda: resample_gather_split(
            [], R.residual_F_fused(gen, w))[1],
        "multinomial (G2)": lambda: resample_gather_split_u(
            [], *R.multinomial_cu(gen, w))[1],
        "stratified (G2)": lambda: resample_gather_split_u(
            [], *R.stratified_cu(gen, w))[1],
        "multinomial (G4)": lambda: R.multinomial_parents(gen, w),
        "residual (G4)": lambda: R.residual_parents(gen, w),
        "stratified F": lambda: R._F_to_parents(R.stratified_F(gen, w), n)}
    for label, fn in routes.items():
        picked = int((w[fn().long()] == 0).sum())
        if picked:
            raise AssertionError(f"4k: {label} picked {picked} particles of "
                                 f"weight 0")
    # the same systematic draw from a float32 scan of the weights, as the
    # port summed them before: what the float64 sum guards against
    u0 = torch.rand((), generator=gen, device="cuda")
    f32 = R._pinned_F(torch.floor(n * torch.cumsum(w, 0) - u0).to(
        torch.int32) + 1, n)
    f32_picks = int((w[R._F_to_parents(f32, n).long()] == 0).sum())
    print(f"[4k zero weights] N={n}, 90% of weights exactly 0: no route "
          f"picked one ({', '.join(routes)}); systematic from a float32 "
          f"scan would have picked {f32_picks}")


def _sv_path():
    """(k): config 3 at N=100K, T=100 against the bootstrap reference."""
    import genparticlefilters_tpu_torch as g
    _zero_weight_check()
    p, y, run = _sv_setup()
    st, counts = _path(f"4k config 3 SV N={N_SV} T={T_SV}",
                       lambda: run(_gen(800), y, N_SV), (G1,))
    ess = float(g.effective_sample_size(st))
    var = float(g.var(st, (T_SV - 1, "h")))
    if not (bool(torch.isfinite(st.log_weights).all()) and 1 <= ess <= N_SV
            and var > 0):
        raise AssertionError(f"4k: weights not finite, ESS {ess} or "
                             f"var(h_T-1) {var}")
    print(f"[4k config 3] N={N_SV} T={T_SV}: ESS {ess:.1f}, var(h_T-1) "
          f"{var:.4f}")
    _sv_lml_gate("4k config 3", run, y, p)
    return counts


_BOOTSTRAP = {}      # seed -> the bootstrap reference's LML on the 4k data


def _sv_lml_gate(label, run, y, p):
    """The mean LML of 4 seeds of ``run`` against the independent
    bootstrap filter at N=1M (4 seeds, computed once) within
    6·(combined stderr) + 0.05, every seed within 1 nat."""
    import genparticlefilters_tpu_torch as g
    lmls = [float(g.log_ml_estimate(run(_gen(810 + s), y, N_SV)))
            for s in range(4)]
    for s in range(4):
        if 820 + s not in _BOOTSTRAP:
            _BOOTSTRAP[820 + s] = _sv_bootstrap_lml(y, N_SV_REF, p, 820 + s)
    refs = [_BOOTSTRAP[820 + s] for s in range(4)]
    se = math.sqrt(np.var(lmls) / 4 + np.var(refs) / 4)
    lim = 6 * se + 0.05
    diff = abs(np.mean(lmls) - np.mean(refs))
    # each seed too: one far seed inflates the stderr enough to pass the
    # mean (resampling that picks zero-weight particles shows as a seed
    # tens of nats high)
    far = max(abs(x - np.mean(refs)) for x in lmls)
    if diff >= lim or far >= 1.0:
        raise AssertionError(f"{label}: LML {lmls} vs bootstrap {refs}")
    print(f"[{label}] N={N_SV} T={T_SV}: mean LML of 4 seeds "
          f"{np.mean(lmls):.4f} (sd {np.std(lmls):.4f}) vs an independent "
          f"bootstrap filter at N={N_SV_REF} {np.mean(refs):.4f} (sd "
          f"{np.std(refs):.4f}): |diff| {diff:.4f} (limit 6*stderr+0.05 = "
          f"{lim:.4f}), farthest seed {far:.4f} (limit 1)")


def _tm_run(gen, _y, n):
    from genparticlefilters_tpu_torch.models.tempered import run_tempered_smc
    return run_tempered_smc(gen, n, n_temps=K_TM, rejuv_iters=2)[0]


def _smcp3_translator(beta, scaling=False, batch_safe=True):
    """An SMCP³ translator of the tempered model to inverse temperature
    ``beta``: eps ~ N(0, 0.25) forward and backward, x' = x + eps (or
    x' = x·exp(eps) with its Jacobian, ``scaling``), eps' = −eps. With
    ``batch_safe=False`` the proposals are unmarked: the translator runs
    per particle (path 4r)."""
    import genparticlefilters_tpu_torch as g

    @g.gen
    def fwd(tr):
        g.trace("eps", g.normal(0.0, 0.25))
    fwd.batch_safe = batch_safe

    def shift(prev, f):
        eps, x = f[("eps",)], prev[("x",)]
        new_x = x * torch.exp(eps) if scaling else x + eps
        return (g.ChoiceMap({("x",): g.Entry(new_x, True)}),
                g.ChoiceMap({("eps",): g.Entry(-eps, True)}))
    io = (dict(continuous_in=(("prev", "x"), ("fwd", "eps")),
               continuous_out=(("model", "x"), ("bwd", "eps")))
          if scaling else {})
    return g.UpdatingTraceTranslator(
        p_new_args=(beta,), p_argdiffs=(g.UnknownChange(),), q_forward=fwd,
        q_backward=fwd, transform=g.TraceTransform(shift, **io))


def _smcp3_run(gen, _y, n, batch_safe=True):
    """tempered_smc's loop with the args-update replaced by an SMCP³
    translator; the ESS-triggered systematic resampling stays."""
    import genparticlefilters_tpu_torch as g
    from genparticlefilters_tpu_torch.models.tempered import (
        make_tempered_model)
    from genparticlefilters_tpu_torch.utils.spans import span
    betas = torch.linspace(0.0, 1.0, K_TM, device=gen.device) ** 2
    with span("tm.initialize"):
        st = g.pf_initialize(gen, make_tempered_model(), (betas[0],),
                             g.EMPTY, n)
    for i in range(1, K_TM):
        with span("tm.ess_check"):
            low = bool(g.effective_sample_size(st) < 0.75 * n)
        if low:
            with span("tm.resample"):
                st = g.pf_resample(gen, st, "systematic", check=False)
        with span("tm.update"):
            st = g.pf_update(gen, st, translator=_smcp3_translator(
                betas[i], batch_safe=batch_safe), check=False)
    return st


def _smcp3_pp_run(gen, _y, n):
    """(r): the SMCP³ loop with unmarked proposals, per particle."""
    return _smcp3_run(gen, _y, n, batch_safe=False)


def _tm_lml_gate(label, run, seed):
    """Mean LML of 4 seeds within 6·stderr + 0.02 of the quadrature."""
    import genparticlefilters_tpu_torch as g
    from genparticlefilters_tpu_torch.models.tempered import tempered_log_z
    lz = tempered_log_z()
    lmls = [float(g.log_ml_estimate(run(_gen(seed + s), None, N_TM)))
            for s in range(4)]
    lim = 6 * np.std(lmls) / 2 + 0.02
    diff = abs(np.mean(lmls) - lz)
    if diff >= lim:
        raise AssertionError(f"{label}: LMLs {lmls} vs log Z {lz}")
    print(f"[{label}] N={N_TM} temperatures={K_TM}: mean LML of 4 seeds "
          f"{np.mean(lmls):.4f} (sd {np.std(lmls):.4f}) vs quadrature log Z "
          f"{lz:.4f}: |diff| {diff:.4f} (limit 6*stderr+0.02 = {lim:.4f})")


def _tempered_paths():
    """(l) and (m): config 4 by args-update and by SMCP³."""
    import genparticlefilters_tpu_torch as g
    from genparticlefilters_tpu_torch.models.tempered import MODES
    st, c_l = _path(f"4l config 4 args-update N={N_TM} K={K_TM}",
                    lambda: _tm_run(_gen(830), None, N_TM), (G1,))
    xs = g.batched_choice(st, "x")
    w = g.get_norm_weights(st)
    lo, hi = float(w[xs < 0].sum()), float(w[xs >= 0].sum())
    near = float(w[((xs[:, None] - torch.tensor(MODES, device="cuda")).abs()
                    < 1.2).any(1)].sum())
    if not (lo > 0.05 and hi > 0.05 and near > 0.95):
        raise AssertionError(f"4l: mode weights {lo}, {hi}; near {near}")
    print(f"[4l config 4] weight on the two modes {lo:.3f}, {hi:.3f} (each "
          f"> 0.05), within 1.2 of a mode {near:.4f} (> 0.95)")
    _tm_lml_gate("4l config 4", _tm_run, 840)
    _, c_m = _path(f"4m config 4 SMCP3 N={N_TM} K={K_TM}",
                   lambda: _smcp3_run(_gen(850), None, N_TM), (G1,))
    _tm_lml_gate("4m config 4 SMCP3", _smcp3_run, 860)
    _scaling_step()
    return {"4l": c_l, "4m": c_m}


def _scaling_step():
    """One SMCP³ step x' = x·exp(eps) at N=100K: its weights (vmapped
    jacfwd log-determinants) against their float64 recomputation."""
    import genparticlefilters_tpu_torch as g
    from genparticlefilters_tpu_torch.models.tempered import (
        make_tempered_model, MODES, MODE_SCALE, PRIOR_LOC, PRIOR_SCALE)
    b0, b1 = 0.2, 0.9
    gen = _gen(870)
    st = g.pf_initialize(gen, make_tempered_model(),
                         (torch.tensor(b0, device="cuda"),), g.EMPTY, N_TM)
    st2 = g.pf_update(gen, st, translator=_smcp3_translator(
        torch.tensor(b1, device="cuda"), scaling=True), check=False)
    x0 = g.batched_choice(st, "x").double().cpu().numpy()
    x1 = g.batched_choice(st2, "x").double().cpu().numpy()
    eps = np.log(x1 / x0)

    def lpn(v, mu, s):
        return -0.5 * ((v - mu) / s) ** 2 - math.log(s) - 0.5 * math.log(
            2 * math.pi)

    def score(x, beta):
        lik = np.logaddexp(*[lpn(x, m, MODE_SCALE) for m in MODES])
        return lpn(x, PRIOR_LOC, PRIOR_SCALE) + beta * (lik - math.log(2))
    want = (score(x1, b1) - score(x0, b0) + eps - lpn(eps, 0, 0.25)
            + lpn(-eps, 0, 0.25))
    got = (st2.log_weights - st.log_weights).double().cpu().numpy()
    err = float(np.max(np.abs(got - want)))
    if not err < 5e-4:
        raise AssertionError(f"4m scaling step: weights off by {err}")
    print(f"[4m scaling step] N={N_TM} x' = x*exp(eps): weights vs float64 "
          f"recomputation max |err| {err:.2e} (limit 5e-4)")


def _strata_model():
    """a ~ U{0,1,2}, c ~ Bern(0.4), x ~ N(a + 0.5c, 1) and, from n = 2,
    b ~ Bern(0.3) and z ~ N(x + 2b, 0.5)."""
    import genparticlefilters_tpu_torch as g

    @g.gen
    def model(n):
        a = g.trace("a", g.uniform_discrete(0, 2))
        c = g.trace("c", g.bernoulli(0.4))
        x = g.trace("x", g.normal(a + torch.where(c, 0.5, 0.0), 1.0))
        if n >= 2:
            b = g.trace("b", g.bernoulli(0.3))
            g.trace("z", g.normal(x + torch.where(b, 2.0, 0.0), 0.5))
        return x
    model.batch_safe = True
    return model


def _strata_check():
    """Stratified pf_initialize (a x c, 6 strata, contiguous) and a
    stratified pf_update adding b and z (2 strata, interleaved) at
    N=100K: every choice is fixed, so every weight is exact."""
    import genparticlefilters_tpu_torch as g
    n = N_STRATA
    obs = g.ChoiceMap({("x",): g.Entry(torch.tensor(0.7, device="cuda"))})
    st = g.pf_initialize(_gen(880), _strata_model(), (1,), obs, n,
                         strata=g.choiceproduct(("a", [0, 1, 2]),
                                                ("c", [False, True])))
    st2 = g.pf_update(_gen(881), st, (2,), (g.UnknownChange(),),
                      g.ChoiceMap({("z",): g.Entry(torch.tensor(
                          1.5, device="cuda"))}),
                      strata=g.choiceproduct(("b", [False, True])))
    a, c, b = (g.batched_choice(st2, k).double() for k in ("a", "c", "b"))

    def lpn(v, mu, s):
        return -0.5 * ((v - mu) / s) ** 2 - math.log(s) - 0.5 * math.log(
            2 * math.pi)

    def lpb(v, q):
        return v * math.log(q) + (1 - v) * math.log(1 - q)
    w1 = (math.log(1 / 3) + lpb(c, 0.4) + lpn(0.7, a + 0.5 * c, 1.0)
          + math.log(6))
    w2 = w1 + lpb(b, 0.3) + lpn(1.5, 0.7 + 2 * b, 0.5) + math.log(2)
    err = max(float((st.log_weights.double() - w1).abs().max()),
              float((st2.log_weights.double() - w2).abs().max()))
    blk = n // 6
    k = (torch.arange(6 * blk, device="cuda") // blk).double()
    layout_ok = (torch.equal((a * 2 + c)[:6 * blk], k) and torch.equal(
        b, (torch.arange(n, device="cuda") % 2).double()))
    if not (err < 1e-4 and layout_ok):
        raise AssertionError(f"4n strata: weights off by {err}, layout "
                             f"{layout_ok}")
    print(f"[4n strata] N={n}: stratified pf_initialize (6 strata, "
          f"contiguous) and pf_update adding b, z (2 strata, interleaved): "
          f"weights vs exact max |err| {err:.2e} (limit 1e-4); strata laid "
          f"out as asked")


def _assess_check():
    """assess of choices built from Python values, given an argument on
    the card, scores on the card with no host sync, and exactly."""
    import genparticlefilters_tpu_torch as g
    from genparticlefilters_tpu_torch.models.tempered import (
        make_tempered_model, MODES, MODE_SCALE, PRIOR_LOC, PRIOR_SCALE)
    beta, x = 0.5, 0.3
    args = (torch.full((), beta, device="cuda"),)
    (r, s), syncs = _synced(lambda: g.assess(
        make_tempered_model(), args, g.choicemap(("x", x), ("lik", 0.0))))

    def lpn(v, mu, sd):
        return -0.5 * ((v - mu) / sd) ** 2 - math.log(sd) - 0.5 * math.log(
            2 * math.pi)
    lik = np.logaddexp(*[lpn(x, m, MODE_SCALE) for m in MODES]) - math.log(2)
    err = abs(float(s) - (lpn(x, PRIOR_LOC, PRIOR_SCALE) + beta * lik))
    if s.device.type != "cuda" or r.device.type != "cuda" or syncs \
            or not err < 1e-5:
        raise AssertionError(f"4n assess: score on {s.device}, retval on "
                             f"{r.device}, syncs {syncs}, |err| {err}")
    print(f"[4n assess] choices from Python values, args on the card: "
          f"score on {s.device}, no host sync, |err| {err:.2e} (limit 1e-5)")


def _om_short_state(y_obs, batch_safe=True):
    """The object-motion filter of path 4 stopped one step short of T (the
    path-4 state has no step left to extend); per particle with
    ``batch_safe=False``."""
    import genparticlefilters_tpu_torch as g
    from genparticlefilters_tpu_torch.models.object_motion import (
        make_object_motion, init_state, obs_dense)
    gen = _gen(890)
    x0, obs = init_state("cuda"), obs_dense(y_obs)
    st = g.pf_initialize(gen, make_object_motion(T_MAIN, batch_safe),
                         (1, x0), obs, N_MAIN)
    for t in range(1, T_MAIN - 1):
        if bool(g.effective_sample_size(st) < 0.5 * N_MAIN):
            st = g.pf_resample(gen, st, "systematic", check=False)
        st = g.pf_update(gen, st, (t + 1, x0), (g.Extend(1), g.NoChange()),
                         obs, check=False)
    return st, x0, obs


def _view_check(label, state, verb):
    """``verb(gen, view)`` on the first half of ``state``: particles of
    the other half come back bit-equal, the view's as ``verb`` run on the
    taken block with the same seed returns them."""
    import genparticlefilters_tpu_torch as g
    from genparticlefilters_tpu_torch.core.batching import (
        tree_take, flatten_with_axes)
    n = state.n_particles
    view = state[0:n // 2]
    idx, rest = view.idxs.long(), torch.arange(n // 2, n, device="cuda")
    out = verb(_gen(895), view)
    ref = verb(_gen(895), g.ParticleFilterState(
        view.traces, view.log_weights, state.log_ml_est, view.parents))
    leaves, axes, _ = flatten_with_axes(state.traces)
    outs = flatten_with_axes(out.traces)[0]
    refs = flatten_with_axes(ref.traces)[0]
    moved = 0
    for x, ax, o, r in zip(leaves, axes, outs, refs):
        if ax is None or not isinstance(x, torch.Tensor) or x.dim() <= ax:
            continue
        if not torch.equal(o.index_select(ax, rest),
                           x.index_select(ax, rest)):
            raise AssertionError(f"4n {label}: the other half changed")
        if not torch.equal(o.index_select(ax, idx), r):
            raise AssertionError(f"4n {label}: the view differs from the "
                                 f"verb on the block")
        moved += int((o.index_select(ax, idx) != x.index_select(ax, idx))
                     .any())
    if not (torch.equal(out.log_weights[rest], state.log_weights[rest])
            and torch.equal(out.log_weights[idx], ref.log_weights)):
        raise AssertionError(f"4n {label}: weights")
    print(f"[4n view] {label} on half of N={n}: other half bit-unchanged; "
          f"the view bit-equal to the verb on the taken block ({moved} "
          f"particle leaves changed)")


def _views_check(main_state, y_obs):
    import genparticlefilters_tpu_torch as g
    steps = torch.arange(T_MAIN, device="cuda")
    m = (steps == T_MAIN - 2) | (steps == T_MAIN - 1)
    sel = g.Selection({("moving",): m, ("y",): m})
    _view_check("pf_rejuvenate move (mh, window 2) of the path-4 state",
                main_state, lambda gen, s: g.pf_rejuvenate(
                    gen, s, g.mh, (sel,), window=2))
    _view_check("pf_rejuvenate reweight (move_reweight, window 2) of the "
                "path-4 state", main_state, lambda gen, s: g.pf_rejuvenate(
                    gen, s, g.move_reweight, (sel,), window=2,
                    method="reweight"))
    short, x0, obs = _om_short_state(y_obs)
    _view_check(f"pf_update Extend(1) of the path-4 model at t={T_MAIN - 1}",
                short, lambda gen, s: g.pf_update(
                    gen, s, (T_MAIN, x0), (g.Extend(1), g.NoChange()), obs,
                    check=False))


def _config34_paths(y_obs, main_state):
    """Paths (k)-(n); returns the launch counts of each."""
    seen = {"4k": _sv_path()}
    seen.update(_tempered_paths())

    def strata_views():
        _strata_check()
        _assess_check()
        _views_check(main_state, y_obs)
    _, seen["4n"] = _path("4n strata and views", strata_views, ())
    return seen


# ---------------------------------------------------------------------------
# Sub-generative-function calls: the line model and a plate (paths 4o, 4p)
# ---------------------------------------------------------------------------

def _line_setup():
    """(the line model, its Unfold, y_0..y_9): the twin of the reference's
    test model (tests/fixtures.py): slope ~ uniform_discrete(-2, 2); per
    step x = t + 1, outlier ~ bernoulli(0.1), y ~ N(x·slope, outlier ? 10
    : 1), the steps an Unfold called at "line". The data come from its
    generate with slope constrained to 1 (seed 780)."""
    import genparticlefilters_tpu_torch as g

    @g.gen
    def line_step(t, x, slope):
        x = x + 1.0
        outlier = g.trace("outlier", g.bernoulli(0.1))
        g.trace("y", g.normal(x * slope, torch.where(outlier, 10.0, 1.0)))
        return x
    line_step.batch_safe = True
    unfold = g.Unfold(line_step, T_LINE)

    @g.gen
    def line_model(n):
        slope = g.trace("slope", g.uniform_discrete(-2, 2))
        x0 = slope.new_zeros((), dtype=torch.float32)
        g.trace("line", unfold, (n, x0, slope.to(torch.float32)))
        return slope
    line_model.batch_safe = True
    with g.batched_interpretation(1):
        tr, _ = line_model.generate(_gen(780), (T_LINE,),
                                    g.choicemap(("slope", 1)))
    y = [float(v) for v in tr.get_choices()[("line", "y")][:, 0].cpu()]
    return line_model, unfold, y


def _line_exact(y):
    """(P(slope = s | y) for s = -2..2, log Z) by enumeration in float64:
    p(s | y) ∝ (1/5) Π_t [0.9 N(y_t; (t+1)s, 1)
                          + 0.1 N(y_t; (t+1)s, 10)]."""
    def lnorm(v, m, sd):
        return (-0.5 * ((v - m) / sd) ** 2 - math.log(sd)
                - 0.5 * math.log(2 * math.pi))
    lj = []
    for s in range(-2, 3):
        lp = math.log(1 / 5)
        for t, v in enumerate(y):
            a = math.log(0.9) + lnorm(v, (t + 1) * s, 1.0)
            b = math.log(0.1) + lnorm(v, (t + 1) * s, 10.0)
            lp += max(a, b) + math.log1p(math.exp(-abs(a - b)))
        lj.append(lp)
    lj = np.array(lj)
    log_z = lj.max() + math.log(np.exp(lj - lj.max()).sum())
    return np.exp(lj - log_z), log_z


def _line_run(route, model):
    """The reference README's filter on ``model``, the line model, as
    ``run(gen, y, n)``. Route A: pf_update with UnknownChange (the full re-scan through
    the call site) and systematic resampling (G1); route B: Extend(1,
    at="line") (the O(1) extension) and residual resampling (G2 count +
    G1). Both: when the ESS falls below N/2, resample, then MH on the
    slope with the full re-scan regenerate (window=None)."""
    import genparticlefilters_tpu_torch as g
    from genparticlefilters_tpu_torch.utils.spans import span
    method, diffs = (("systematic", (g.UnknownChange(),)) if route == "A"
                     else ("residual", (g.Extend(1, at="line"),)))

    def run(gen, y, n):
        with span("lm.initialize"):
            st = g.pf_initialize(gen, model, (0,), g.EMPTY, n)
        for t in range(1, T_LINE + 1):
            with span("lm.ess_check"):
                low = bool(g.effective_sample_size(st) < n / 2)
            if low:
                with span("lm.resample"):
                    st = g.pf_resample(gen, st, method, check=False)
                with span("lm.rejuvenate"):
                    st = g.pf_rejuvenate(gen, st, g.mh,
                                         (g.select("slope"),))
            with span("lm.update"):
                st = g.pf_update(gen, st, (t,), diffs, g.choicemap(
                    (("line", t - 1, "y"), y[t - 1])))
        return st
    return run


def _line_path(route, need, line, label="4o"):
    """(o), one route: the counted run (launches, host syncs, step bodies,
    the storage on the card), then the gate over 4 seeds against the exact
    enumeration: mean LML within 6·stderr + 0.05 of log Z and every seed
    within 0.5; P(slope = s) within 6·stderr + 0.02 for every s. (r) runs
    it on an unmarked copy of the model, per particle."""
    import genparticlefilters_tpu_torch as g
    model, unfold, y = line
    post, log_z = _line_exact(y)
    run = _line_run(route, model)
    before, maps = unfold.steps_run, _boundary()
    (st, syncs), counts = _path(
        f"{label} line model route {route} N={N_LINE} T={T_LINE}",
        lambda: _synced(lambda: run(_gen(870), y, N_LINE)), need)
    bodies = unfold.steps_run - before
    if len(syncs) > T_LINE:
        raise AssertionError(f"{label} route {route}: {len(syncs)} host "
                             f"syncs, more than the {T_LINE} ESS checks: "
                             f"{syncs}")
    store = st.traces.inner["subs"][("line",)].inner["store"]
    if (store.mat.device.type != "cuda" or not store.mat.is_contiguous()
            or tuple(store.mat.shape) != (3 * T_LINE, N_LINE)):
        raise AssertionError(f"{label}: store {tuple(store.mat.shape)} on "
                             f"{store.mat.device}")
    maps = _boundary_since(maps)
    lmls, probs = [], []
    for s in range(4):
        st = run(_gen(880 + s), y, N_LINE)
        lmls.append(float(g.log_ml_estimate(st)))
        pm = g.proportionmap(st, "slope")
        probs.append([pm.get(k, 0.0) for k in range(-2, 3)])
    lmls, probs = np.array(lmls), np.array(probs)
    lim = 6 * lmls.std() / 2 + 0.05
    diff, far = abs(lmls.mean() - log_z), float(np.abs(lmls - log_z).max())
    p_err = np.abs(probs.mean(0) - post)
    p_lim = 6 * probs.std(0) / 2 + 0.02
    if diff >= lim or far >= 0.5 or np.any(p_err >= p_lim):
        raise AssertionError(f"{label} route {route}: LMLs {lmls} vs log Z "
                             f"{log_z}; P(slope) {probs.mean(0)} vs {post}")
    print(f"[{label} route {route}] one run: {len(syncs)} host syncs (limit "
          f"{T_LINE}, the ESS checks), {maps['calls']} per-particle maps "
          f"({maps['copies']} boundary copies, {maps['bytes'] / 1e6:.1f} "
          f"MB), {bodies} Unfold step bodies, mat "
          f"{tuple(store.mat.shape)} int32 on cuda; 4 seeds: mean LML "
          f"{lmls.mean():.4f} vs exact log Z {log_z:.4f} (|diff| {diff:.4f}, "
          f"limit {lim:.4f}; farthest seed {far:.4f}, limit 0.5); P(slope = "
          f"-2..2) {np.round(probs.mean(0), 4).tolist()} vs exact "
          f"{np.round(post, 4).tolist()} (max |diff| {p_err.max():.4f})")
    return counts


def _plate_setup():
    """The plate model, its observations, exact log Z and exact posterior
    mean of mu (a dict): mu ~ N(0, 1); at "plate" a MapCombinator of 8
    units x_i ~ N(mu, 1), y_i ~ N(x_i, 0.5), every y_i observed at 0.5
    (stored shared: one [8] row). y_i | mu ~ N(mu, 1.25) iid, so log Z is
    the log-density of y under N(0, 1.25 I + 1 1ᵀ)."""
    import genparticlefilters_tpu_torch as g

    @g.gen
    def unit(i, mu):
        x = g.trace("x", g.normal(mu, 1.0))
        g.trace("y", g.normal(x, 0.5))
        return x
    unit.batch_safe = True
    plate = g.MapCombinator(unit, D_PLATE)

    @g.gen
    def plate_model(idx):
        mu = g.trace("mu", g.normal(0.0, 1.0))
        g.trace("plate", plate, (idx, mu))
        return mu
    plate_model.batch_safe = True
    y = np.full(D_PLATE, Y_PLATE)
    cov = 1.25 * np.eye(D_PLATE) + 1.0
    return {"model": plate_model,
            "obs": g.ChoiceMap({("plate", "y"): g.Entry(
                torch.full((D_PLATE,), Y_PLATE, device="cuda"), True)}),
            "log_z": float(-0.5 * y @ np.linalg.solve(cov, y)
                           - 0.5 * np.linalg.slogdet(2 * math.pi * cov)[1]),
            "mean": y.sum() / 1.25 / (1 + D_PLATE / 1.25)}


def _plate_run(p):
    """``run(gen, _, n)``: pf_initialize of the plate model ``p``,
    systematic resampling (G1 gathers the [N, 8] plate leaves), then two
    MH sweeps on mu through the call site."""
    import genparticlefilters_tpu_torch as g
    from genparticlefilters_tpu_torch.utils.spans import span

    def run(gen, _y, n):
        with span("mp.initialize"):
            st = g.pf_initialize(gen, p["model"], (torch.arange(
                D_PLATE, device=gen.device),), p["obs"], n)
        with span("mp.resample"):
            st = g.pf_resample(gen, st, "systematic", check=False)
        with span("mp.rejuvenate"):
            return g.pf_rejuvenate(gen, st, g.mh, (g.select("mu"),), 2)
    return run


def _plate_path(p):
    """(p): the plate model at N=100K: launches and host syncs of one run,
    which kernel gathered the [N, 8] plate leaves; over 8 seeds the mean
    LML within 0.05 of log Z and the posterior mean of mu within
    6·stderr + 0.02."""
    import genparticlefilters_tpu_torch as g
    from genparticlefilters_tpu_torch.core.batching import flatten_with_axes
    run = _plate_run(p)
    (st, syncs), counts = _path(f"4p plate N={N_PLATE} n={D_PLATE}",
                                lambda: _synced(lambda: run(
                                    _gen(890), None, N_PLATE)), (G1,))
    if syncs:
        raise AssertionError(f"4p: host syncs {syncs}")
    leaves, axes, _ = flatten_with_axes(st.traces)
    wide = [tuple(l.shape) for l, ax in zip(leaves, axes)
            if ax == 0 and tuple(l.shape) == (N_PLATE, D_PLATE)]
    shared = tuple(st.traces.get_choices()[("plate", "y")].shape)
    if not wide or shared != (D_PLATE,):
        raise AssertionError(f"4p: plate leaves {wide}, y stored {shared}")
    lmls, means = [], []
    for s in range(8):
        st = run(_gen(900 + s), None, N_PLATE)
        lmls.append(float(g.log_ml_estimate(st)))
        means.append(float(g.mean(st, "mu")))
    diff = abs(np.mean(lmls) - p["log_z"])
    m_err = abs(np.mean(means) - p["mean"])
    m_lim = 6 * np.std(means) / math.sqrt(8) + 0.02
    if diff >= 0.05 or m_err >= m_lim:
        raise AssertionError(f"4p: LMLs {lmls} vs log Z {p['log_z']}; "
                             f"means {means} vs {p['mean']}")
    print(f"[4p plate] the systematic pf_resample gathered the {len(wide)} "
          f"[N, {D_PLATE}] plate leaves (x, scores, retvals, args) packed "
          f"particle-last through {G1}: {counts[G1]} launches in the run; "
          f"y stored shared {shared}; no host sync; 8 seeds: mean LML "
          f"{np.mean(lmls):.4f} vs exact log Z {p['log_z']:.4f} (|diff| "
          f"{diff:.4f}, limit 0.05); posterior mean of mu {np.mean(means):.4f}"
          f" vs exact {p['mean']:.4f} (|diff| {m_err:.4f}, limit "
          f"{m_lim:.4f})")
    return counts


def _call_site_paths():
    """Paths (o) and (p); returns the launch counts of each."""
    line = _line_setup()
    return {"4o A": _line_path("A", (G1,), line),
            "4o B": _line_path("B", (G1, G2), line),
            "4p": _plate_path(_plate_setup())}


# ---------------------------------------------------------------------------
# The per-particle interpretation (paths 4q-4s), the 19 distributions,
# checkpointing, and the reproducibility of routes 4o B and 4c
# ---------------------------------------------------------------------------

def _boundary():
    from genparticlefilters_tpu_torch.core.batching import BOUNDARY
    return dict(BOUNDARY)


def _boundary_since(before):
    after = _boundary()
    return {k: after[k] - before[k] for k in after}


def _pp_om_run(method, batch_safe=False):
    """The headline filter with the step body unmarked (per particle:
    initialize, Extend updates and windowed MH each one vmap_gfi map)."""
    from genparticlefilters_tpu_torch.models.object_motion import (
        object_motion_filter)
    return lambda gen, y, n: object_motion_filter(
        gen, y, n, T_MAIN, resample_method=method, batch_safe=batch_safe)


def _pp_om_path(y_obs):
    """(q): per particle, systematic (G1) and residual (G2 count + G1):
    one counted run (launches, host syncs, boundary copies), the batched
    run from the same seed beside it, then phase 4's posterior gate."""
    seen = {}
    for method, need in (("systematic", (G1,)), ("residual", (G1, G2))):
        run = _pp_om_run(method)
        label = f"4q object motion per particle {method} N={N_MAIN}"
        maps = _boundary()
        (st, syncs), seen[f"4q {method}"] = _path(
            label, lambda: _synced(lambda: run(_gen(100), y_obs, N_MAIN)),
            need)
        maps = _boundary_since(maps)
        if len(syncs) > MAX_SYNCS:
            raise AssertionError(f"4q {method}: {len(syncs)} host syncs: "
                                 f"{syncs}")
        mat = st.traces.inner["store"].mat
        if not (mat.device.type == "cuda" and mat.is_contiguous()
                and tuple(mat.shape) == (5 * T_MAIN, N_MAIN)):
            raise AssertionError(f"4q: store {tuple(mat.shape)}")
        ref = _filter(method)(_gen(100), y_obs, N_MAIN)
        same = torch.equal(st.log_weights, ref.log_weights)
        print(f"[4q {method}] one run: {len(syncs)} host syncs (limit "
              f"{MAX_SYNCS}); {maps['calls']} per-particle maps, "
              f"{maps['copies']} boundary copies ({maps['bytes'] / 1e6:.1f} "
              f"MB); mat {tuple(mat.shape)} int32 (y_obs per particle, as "
              f"JAX's vmapped layout); log weights bit-equal to the batched "
              f"run of the same seed: {same}")
        _posterior_check(run, y_obs, N_MAIN, f"4q {method}")
    return seen


def _pp_line_smcp3_paths():
    """(r): the line model unmarked, route B; the SMCP³ loop with its
    forward and backward proposals unmarked (both per particle)."""
    import copy
    model, unfold, y = _line_setup()
    pp = copy.copy(model)
    pp.batch_safe = False
    seen = {"4r line B": _line_path("B", (G1, G2), (pp, unfold, y),
                                    label="4r per particle")}
    maps = _boundary()
    (_, syncs), seen["4r SMCP3"] = _path(
        f"4r SMCP3 per particle N={N_TM} K={K_TM}",
        lambda: _synced(lambda: _smcp3_pp_run(_gen(850), None, N_TM)), (G1,))
    maps = _boundary_since(maps)
    if len(syncs) > K_TM - 1:
        raise AssertionError(f"4r SMCP3: {len(syncs)} host syncs: {syncs}")
    print(f"[4r SMCP3] one run: {len(syncs)} host syncs (limit {K_TM - 1}); "
          f"{maps['calls']} per-particle maps, {maps['copies']} boundary "
          f"copies ({maps['bytes'] / 1e6:.1f} MB)")
    _tm_lml_gate("4r SMCP3 per particle", _smcp3_pp_run, 860)
    return seen


X_QUAD = (-1.0, -0.7, -0.4, -0.1, 0.2, 0.5, 0.8, 1.0)
Y_QUAD = (0.5, 0.2, -0.1, 0.3, 0.8, 1.0, 1.6, 2.1)


def _quad_setup(batch_safe=False):
    """(s): mu ~ mvnormal_diag(0, I_3), y_i ~ N(mu[0] + mu[1]·x_i +
    mu[2]·x_i², 1) at 8 fixed x_i, every y_i observed. Unmarked, it reads
    mu[k] per particle; ``batch_safe=True`` gives the batch-polymorphic
    rewrite (mu[..., k]), the batched counterpart timed in phase 5.
    Returns (model, args, observations, log Z, posterior mean of mu),
    those two exact: y ~ N(0, I + Φ Φᵀ)."""
    import genparticlefilters_tpu_torch as g
    xs = torch.tensor(X_QUAD, device="cuda")

    @g.gen
    def quadratic(xv):
        mu = g.trace("mu", g.mvnormal_diag(torch.zeros(3, device="cuda"),
                                           torch.ones(3, device="cuda")))
        m = [mu[..., k] if batch_safe else mu[k] for k in range(3)]
        for i in range(len(X_QUAD)):
            g.trace(("y", i), g.normal(m[0] + m[1] * xv[i]
                                       + m[2] * xv[i] ** 2, 1.0))
        return mu
    quadratic.batch_safe = batch_safe
    obs = g.choicemap(*[(("y", i), v) for i, v in enumerate(Y_QUAD)])
    x, y = np.array(X_QUAD), np.array(Y_QUAD)
    phi = np.stack([np.ones(8), x, x ** 2], 1)
    cov = np.eye(8) + phi @ phi.T
    log_z = float(-0.5 * y @ np.linalg.solve(cov, y)
                  - 0.5 * np.linalg.slogdet(2 * math.pi * cov)[1])
    post = np.linalg.solve(np.eye(3) + phi.T @ phi, phi.T @ y)
    return quadratic, (xs,), obs, log_z, post


def _quad_run(batch_safe=False):
    """``run(gen, _, n)``: initialize, systematic resampling (G1), two MH
    sweeps on mu."""
    import genparticlefilters_tpu_torch as g
    model, args, obs, _, _ = _quad_setup(batch_safe)

    def run(gen, _y, n):
        st = g.pf_initialize(gen, model, args, obs, n)
        st = g.pf_resample(gen, st, "systematic", check=False)
        return g.pf_rejuvenate(gen, st, g.mh, (g.select("mu"),), 2)
    return run


def _collide(k):
    import genparticlefilters_tpu_torch as g

    @g.gen
    def collide_model(_):
        base = torch.arange(k, dtype=torch.float32, device="cuda")
        return g.trace("x", g.normal(base, 1.0))
    collide_model.batch_safe = True
    return collide_model


def _pp_quad_path():
    """(s): the positional model per particle at N=100K (no host sync, G1),
    8 seeds against the conjugate log Z and posterior mean; then the
    guard's collision model on the card."""
    import genparticlefilters_tpu_torch as g
    _, _, _, log_z, post = _quad_setup()
    run = _quad_run()
    (st, syncs), counts = _path(f"4s positional model per particle "
                                f"N={N_MAIN}", lambda: _synced(lambda: run(
                                    _gen(920), None, N_MAIN)), (G1,))
    if syncs:
        raise AssertionError(f"4s: host syncs {syncs}")
    lmls, means = [], []
    for s in range(8):
        st = run(_gen(930 + s), None, N_MAIN)
        lmls.append(float(g.log_ml_estimate(st)))
        w = g.get_norm_weights(st).double()
        means.append((w[:, None] * g.batched_choice(st, "mu").double()
                      ).sum(0).cpu().numpy())
    lmls, means = np.array(lmls), np.array(means)
    lim = 6 * lmls.std(ddof=1) / math.sqrt(8) + 0.05
    m_lim = 6 * means.std(0, ddof=1) / math.sqrt(8)
    diff, m_err = abs(lmls.mean() - log_z), np.abs(means.mean(0) - post)
    if diff >= lim or np.any(m_err >= m_lim):
        raise AssertionError(f"4s: LMLs {lmls} vs {log_z}; means {means} vs "
                             f"{post}")
    print(f"[4s positional model] no host sync; 8 seeds: mean LML "
          f"{lmls.mean():.4f} vs conjugate log Z {log_z:.4f} (|diff| "
          f"{diff:.4f}, limit {lim:.4f}); posterior mean of mu "
          f"{np.round(means.mean(0), 4).tolist()} vs exact "
          f"{np.round(post, 4).tolist()} (|diff| {np.round(m_err, 4)}, "
          f"limit 6*stderr {np.round(m_lim, 4)})")
    st = g.pf_initialize(_gen(1), _collide(64), (0,), g.EMPTY, 32)
    try:
        g.pf_initialize(_gen(1), _collide(64), (0,), g.EMPTY, 64)
    except ValueError as e:
        if "misread as per-particle" not in str(e):
            raise
    else:
        raise AssertionError("4s guard: the collision at N=64 did not raise")
    print(f"[4s guard] an event vector of length 64 under a batched "
          f"interpretation: N=32 runs ({tuple(g.batched_choice(st, 'x').shape)}"
          f"), N=64 raises 'misread as per-particle'")
    return counts


def _dist_cases():
    """name -> (args on the card, values to score, (mean, var) per event
    element of a draw, or the kind of check)."""
    c = lambda v: torch.tensor(v, device="cuda")  # noqa: E731
    loc, sd = [0.5, -1.0, 2.0], [0.5, 1.0, 2.0]
    cov = [[2.0, 0.3, 0.1], [0.3, 1.0, -0.2], [0.1, -0.2, 0.5]]
    f = lambda *v: torch.tensor(v, dtype=torch.float32)  # noqa: E731
    i = lambda *v: torch.tensor(v, dtype=torch.int32)  # noqa: E731
    mvn = torch.linspace(-2, 2, 18).reshape(6, 3)
    return {
        "normal": ((0.5, 2.0), f(-1.0, 0.5, 3.0), (0.5, 4.0)),
        "bernoulli": ((0.3,), torch.tensor([True, False]), (0.3, 0.21)),
        "uniform_discrete": ((-2, 3), i(-3, -2, 0, 3, 4), (0.5, 35 / 12)),
        "factor": ((-1.25,), f(0.0), (0.0, 0.0)),
        "uniform": ((-1.0, 3.0), f(-2.0, -1.0, 0.3, 2.9, 3.5),
                    (1.0, 16 / 12)),
        "categorical": ((c([0.2, -1.0, 1.5, 0.0]),), i(0, 1, 2, 3, -1, 4),
                        "freq"),
        "labeled_categorical": ((c([3, 7, 11]), c([0.2, 0.5, 0.3])),
                                i(3, 7, 11, 5), "freq"),
        "poisson": ((3.5,), i(0, 1, 3, 7, 12, -1), (3.5, 3.5)),
        "gamma": ((2.5, 1.5), f(0.1, 1.0, 3.7, 9.0, -0.5),
                  (3.75, 2.5 * 1.5 ** 2)),
        "beta": ((2.0, 5.0), f(0.05, 0.2, 0.5, 0.9, 1.2),
                 (2 / 7, 10 / (49 * 8))),
        "exponential": ((1.7,), f(0.0, 0.3, 2.0, 5.0, -0.1),
                        (1 / 1.7, 1 / 1.7 ** 2)),
        "geometric": ((0.3,), i(0, 1, 4, 10, -1), (0.7 / 0.3, 0.7 / 0.09)),
        "lognormal": ((0.2, 0.5), f(0.3, 1.0, 2.5, 6.0),
                      (math.exp(0.325),
                       (math.exp(0.25) - 1) * math.exp(0.65))),
        "laplace": ((0.5, 1.5), f(-3.0, 0.0, 0.5, 4.0), (0.5, 4.5)),
        "cauchy": ((1.0, 2.0), f(-10.0, 0.0, 1.0, 3.0), "cauchy"),
        "student_t": ((5.0, 1.0, 2.0), f(-4.0, 0.0, 1.0, 6.0),
                      (1.0, 20 / 3)),
        "mvnormal_diag": ((c(loc), c(sd)), mvn,
                          (np.array(loc), np.array(sd) ** 2)),
        "mvnormal": ((c(loc), c(cov)), mvn,
                     (np.array(loc), np.diag(np.array(cov)))),
        "delta": ((1.5,), f(1.5, 1.0), (1.5, 0.0)),
    }


N_DRAWS = 1_000_000


def _dists_path():
    """dists: each of the 19 distributions' log_prob on the card against
    the CPU (rtol 1e-5), and 1M sample_batched draws against the closed
    form: mean and variance within 6 standard errors (Cauchy: median and
    interquartile range; the categoricals: frequencies)."""
    import genparticlefilters_tpu_torch as g
    gen = _gen(940)
    worst = 0.0
    for name, (args, vals, moments) in _dist_cases().items():
        ctor = getattr(g, name)
        d = ctor(*args)
        d_cpu = ctor(*[a.cpu() if isinstance(a, torch.Tensor) else a
                       for a in args])
        lp = d.log_prob(vals.to("cuda")).cpu()
        ref = d_cpu.log_prob(vals)
        if not (lp.device.type == "cpu" and torch.equal(torch.isinf(lp),
                                                        torch.isinf(ref))):
            raise AssertionError(f"dists {name}: support {lp} vs {ref}")
        fin = torch.isfinite(ref)
        if not torch.allclose(lp[fin], ref[fin], rtol=1e-5, atol=1e-6):
            raise AssertionError(f"dists {name}: log_prob {lp} vs CPU {ref}")
        x = d.sample_batched(gen, N_DRAWS)
        if x.device.type != "cuda" or x.shape[0] != N_DRAWS:
            raise AssertionError(f"dists {name}: draws {x.shape} "
                                 f"{x.device}")
        if moments == "freq":
            p = (torch.softmax(args[0].double(), 0) if name == "categorical"
                 else args[1].double())
            vals_k = (torch.arange(len(p), device="cuda")
                      if name == "categorical" else args[0])
            freq = (x[:, None] == vals_k[None, :]).double().mean(0)
            z = ((freq - p).abs() / torch.sqrt(p * (1 - p) / N_DRAWS)).max()
        elif moments == "cauchy":
            q = torch.quantile(x[:2 ** 24].double(), torch.tensor(
                [0.25, 0.5, 0.75], dtype=torch.float64, device="cuda"))
            # a quantile's stderr: sqrt(p(1-p)/n) over the density there
            se = math.sqrt(0.1875 / N_DRAWS) / (1 / (math.pi * 2.0 * 2.0))
            z = max(abs(float(q[1]) - 1.0), abs(float(q[2] - q[0]) - 4.0)
                    / 2) / se
        else:
            xd = x.double()
            mean = torch.as_tensor(moments[0], dtype=torch.float64,
                                   device="cuda")
            var = torch.as_tensor(moments[1], dtype=torch.float64,
                                  device="cuda")
            m, v = xd.mean(0), xd.var(0)
            if float(var.max()) == 0.0:
                z = float((m - mean).abs().max() + v.abs().max()) * 1e9
            else:
                m4 = ((xd - m) ** 4).mean(0)
                z = max(float(((m - mean).abs()
                               / torch.sqrt(var / N_DRAWS)).max()),
                        float(((v - var).abs()
                               / torch.sqrt((m4 - v ** 2) / N_DRAWS)).max()))
        z = float(z)
        worst = max(worst, z)
        if not z < 6:
            raise AssertionError(f"dists {name}: draws {z:.2f} standard "
                                 f"errors from the closed form")
    print(f"[dists] 19 distributions: log_prob on the card equal to the CPU's "
          f"(rtol 1e-5, same support); {N_DRAWS:,} draws each on the card, "
          f"the farthest moment {worst:.2f} standard errors from the closed "
          f"form (limit 6)")


def _ckpt_path(y_obs):
    """ckpt: save_state of a 4q state (per particle, one step short of T),
    restore_state onto a fresh state of the model, then one more pf_update
    of both from one seed: leaves and next step bit-equal."""
    import tempfile
    import genparticlefilters_tpu_torch as g
    from genparticlefilters_tpu_torch.core.tree import tree_leaves
    from genparticlefilters_tpu_torch.models.object_motion import (
        make_object_motion)
    from genparticlefilters_tpu_torch.utils import save_state, restore_state
    st, x0, obs = _om_short_state(y_obs, batch_safe=False)
    like = g.pf_initialize(_gen(1), make_object_motion(T_MAIN, False),
                           (1, x0), obs, N_MAIN)

    def same(a, b):
        la, lb = tree_leaves(a), tree_leaves(b)
        return len(la) == len(lb) and all(
            (torch.equal(x, y) and x.device == y.device)
            if isinstance(x, torch.Tensor) else x == y
            for x, y in zip(la, lb))
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "state.pt")
        t0 = time.perf_counter()
        save_state(path, st)
        t1 = time.perf_counter()
        restored = restore_state(path, like)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        size = os.path.getsize(path)
    nxt = [g.pf_update(_gen(7), s, (T_MAIN, x0), (g.Extend(1), g.NoChange()),
                       obs, check=False) for s in (st, restored)]
    if not (same(st, restored) and same(*nxt)
            and restored.traces.inner["t"] == T_MAIN - 1):
        raise AssertionError("ckpt: restored state or its next step differs")
    print(f"[ckpt] the N={N_MAIN} per-particle state at t={T_MAIN - 1}: "
          f"{size / 1e6:.1f} MB saved in {(t1 - t0) * 1e3:.1f} ms, restored "
          f"onto the card in {(t2 - t1) * 1e3:.1f} ms; every leaf and the "
          f"next pf_update (same seed) bit-equal")


def _repro_runs():
    """{route: (LML bits, a digest of the log weights)} of one run of 4o B
    and of 4c's multinomial route, each from its fixed seed."""
    import hashlib
    import genparticlefilters_tpu_torch as g
    model, _, y = _line_setup()
    out = {}
    for label, st in (
            ("4o B", _line_run("B", model)(_gen(870), y, N_LINE)),
            ("4c multinomial", _filter("multinomial")(_gen(102), _data(),
                                                       N_MAIN))):
        out[label] = (float(g.log_ml_estimate(st)).hex(), hashlib.sha256(
            st.log_weights.cpu().numpy().tobytes()).hexdigest()[:16])
    return out


def _repro_path():
    """The routes that read other LMLs from one seed in two calls (4o B,
    4c multinomial): first the evidence — torch.cumsum of one float input
    on the card, repeated — then each route twice in this process and once
    in a fresh one, which must agree bit for bit."""
    from genparticlefilters_tpu_torch.smc.resample import (
        _sorted_uniforms_cum, _cumw)
    gen = _gen(990)
    e = torch.empty(N_MAIN + 1, device="cuda").exponential_(generator=gen)
    w = torch.rand(N_MAIN, generator=gen, device="cuda")
    w = w / w.sum()
    scans = {"cumsum float32 of the spacings": lambda: torch.cumsum(e, 0),
             "cumsum float64 of the weights": lambda: torch.cumsum(
                 w, 0, dtype=torch.float64),
             "fixed-point scan of the spacings (the route now)":
                 lambda: _sorted_uniforms_cum(None, N_MAIN, "cuda", e),
             "_cumw (the brackets' float64 scan)": lambda: _cumw(w)}
    for label, fn in scans.items():
        first = fn()
        outs = [fn() for _ in range(49)]
        distinct = 1 + len({o.cpu().numpy().tobytes() for o in outs
                            if not torch.equal(o, first)})
        moved = max(int((o != first).sum()) for o in outs)
        print(f"[repro] {label}: {distinct} distinct results in 50 calls on "
              f"one input (at most {moved} of {first.numel()} elements "
              f"differ from the first call)")
    a, b = _repro_runs(), _repro_runs()
    proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                           "--repro-only"], capture_output=True, text=True,
                          timeout=600)
    if proc.returncode != 0:
        raise RuntimeError(f"--repro-only failed:\n{proc.stderr[-3000:]}")
    fresh = {k: tuple(v) for k, v in json.loads(
        proc.stdout.strip().splitlines()[-1]).items()}
    if not (a == b == fresh):
        raise AssertionError(f"repro: run 1 {a}, run 2 {b}, fresh process "
                             f"{fresh}")
    print(f"[repro] 4o B and 4c multinomial, each twice in this process and "
          f"once in a fresh one from the same seeds: LMLs and log weights "
          f"bit-equal ({ {k: float.fromhex(v[0]) for k, v in a.items()} })")


def _per_particle_paths(y_obs):
    """Paths (q)-(s), dists, ckpt and the reproducibility check; returns
    the launch counts of each path."""
    seen = _pp_om_path(y_obs)
    seen.update(_pp_line_smcp3_paths())
    seen["4s"] = _pp_quad_path()
    _dists_path()
    _ckpt_path(y_obs)
    _repro_path()
    return seen


# ---------------------------------------------------------------------------
# Combinators nested in combinators (paths 4t-4v) and the mesh (path 4w)
# ---------------------------------------------------------------------------

def _nested_models(batch_safe=True):
    """{shape: (model, the Unfolds whose step bodies it runs)}: N1, a plate
    in an Unfold step (x_t ~ N(0.7·x_{t−1}, 0.6), then MapCombinator(obs,
    8) with y_{t,k} ~ N(x_t, 0.5)); N2, a plate of Unfolds
    (MapCombinator(Unfold(ar1_step, T), 4), four AR(1) series each
    observed at every step); N3, an Unfold in an Unfold step (3 AR(1)
    sub-steps per outer step, the last one observed). ``batch_safe=False``
    leaves every body unmarked (per particle)."""
    import genparticlefilters_tpu_torch as g

    @g.gen
    def obs_k(x):
        g.trace("y", g.normal(x, R_NEST))
    plate = g.MapCombinator(obs_k, K1_NEST)

    @g.gen
    def n1_step(t, x):
        x = g.trace("x", g.normal(A_NEST * x, Q_NEST))
        g.trace("obs", plate, (x,))
        return x

    @g.gen
    def ar1_step(t, x):
        x = g.trace("x", g.normal(A_NEST * x, Q_NEST))
        g.trace("y", g.normal(x, R_NEST))
        return x

    @g.gen
    def sub_step(t, x):
        return g.trace("x", g.normal(A_NEST * x, Q_NEST))
    inner = g.Unfold(sub_step, S3_NEST)

    @g.gen
    def n3_step(t, x):
        x = g.trace("sub", inner, (S3_NEST, x))[S3_NEST - 1]
        g.trace("y", g.normal(x, R_NEST))
        return x
    for f in (obs_k, n1_step, ar1_step, sub_step, n3_step):
        f.batch_safe = batch_safe
    n1, ar1 = g.Unfold(n1_step, T_NEST), g.Unfold(ar1_step, T_NEST)
    n3 = g.Unfold(n3_step, T_NEST)
    return {"N1": (n1, (n1,)), "N2": (g.MapCombinator(ar1, K2_NEST), (ar1,)),
            "N3": (n3, (n3, inner))}


def _nested_data(shape, seed=31):
    """One trajectory's observations (drawn by numpy, float32 on the card):
    N1 [T, 8], N2 [4, T], N3 [T]."""
    rng = np.random.default_rng(seed)

    def ar(n):
        x, out = 0.0, []
        for _ in range(n):
            x = A_NEST * x + Q_NEST * rng.normal()
            out.append(x)
        return np.array(out)
    if shape == "N1":
        y = ar(T_NEST)[:, None] + R_NEST * rng.normal(size=(T_NEST, K1_NEST))
    elif shape == "N2":
        y = (np.stack([ar(T_NEST) for _ in range(K2_NEST)])
             + R_NEST * rng.normal(size=(K2_NEST, T_NEST)))
    else:
        y = (ar(T_NEST * S3_NEST)[S3_NEST - 1::S3_NEST]
             + R_NEST * rng.normal(size=T_NEST))
    return torch.from_numpy(y.astype(np.float32)).to("cuda")


def _kalman_log_z(y, a=A_NEST, q2=Q_NEST ** 2):
    """log p(y) of x_t = a·x_{t−1} + N(0, q2) (x_{−1} = 0), each y_{t,k} ~
    N(x_t, 0.5²), in float64 (sequential scalar updates)."""
    y = np.asarray(y.cpu(), np.float64).reshape(len(y), -1)
    m, v, lz = 0.0, 0.0, 0.0
    for yt in y:
        m, v = a * m, a * a * v + q2
        for o in yt:
            s = v + R_NEST ** 2
            lz += -0.5 * (o - m) ** 2 / s - 0.5 * math.log(2 * math.pi * s)
            k = v / s
            m, v = m + k * (o - m), (1 - k) * v
    return lz


def _nested_log_z(shape, y):
    """Exact log Z: N1 a Kalman filter over 8 observations per step; N2
    the sum of four Kalman log Zs; N3 the one-step AR model of coefficient
    a³ and the summed variance."""
    if shape == "N1":
        return _kalman_log_z(y)
    if shape == "N2":
        return sum(_kalman_log_z(y[k]) for k in range(K2_NEST))
    return _kalman_log_z(y, A_NEST ** S3_NEST, Q_NEST ** 2 * sum(
        A_NEST ** (2 * j) for j in range(S3_NEST)))


def _nested_run(shape, model):
    """The filter of the shape as ``run(gen, y, n)``: N1 Extend(1) updates,
    systematic resampling when the ESS falls below N/2, then MH on the x of
    the last two steps through the window-2 regenerate; N2 full re-scan
    updates (UnknownChange) on the new length, residual resampling; N3
    Extend(1) updates, systematic resampling."""
    import genparticlefilters_tpu_torch as g
    from genparticlefilters_tpu_torch.utils.spans import span
    diffs = ((g.UnknownChange(), g.NoChange()) if shape == "N2"
             else (g.Extend(1), g.NoChange()))
    method = "residual" if shape == "N2" else "systematic"
    addr = ("obs", "y") if shape == "N1" else ("y",)

    def run(gen, y, n):
        obs = g.ChoiceMap({addr: g.Entry(y, True)})
        x0 = torch.zeros((K2_NEST,) if shape == "N2" else (),
                         device=gen.device)
        with span("ns.initialize"):
            st = g.pf_initialize(gen, model, (1, x0), obs, n)
        for t in range(1, T_NEST):
            with span("ns.ess_check"):
                low = bool(g.effective_sample_size(st) < n / 2)
            if low:
                with span("ns.resample"):
                    st = g.pf_resample(gen, st, method, check=False)
                if shape == "N1":
                    with span("ns.rejuvenate"):
                        st = g.pf_rejuvenate(
                            gen, st, g.mh,
                            (g.select((t - 1, "x"), (t - 2, "x")),),
                            window=2)
            with span("ns.update"):
                st = g.pf_update(gen, st, (t + 1, x0), diffs, obs,
                                 check=False)
        return st
    return run


def _nested_path(shape, label, need, batch_safe=True):
    """(t)-(v), or (v) per particle: one counted run (launches, host syncs
    at most the T-1 ESS checks, Unfold step bodies, vmap fallbacks fail),
    then 4 seeds against the exact log Z: mean LML within 6·stderr + 0.05,
    every seed within 0.5."""
    import genparticlefilters_tpu_torch as g
    model, unfolds = _nested_models(batch_safe)[shape]
    run = _nested_run(shape, model)
    y = _nested_data(shape)
    log_z = _nested_log_z(shape, y)
    before = [u.steps_run for u in unfolds]
    maps = _boundary()
    (st, syncs), counts = _path(
        f"{label} {shape} N={N_NEST} T={T_NEST}",
        lambda: _synced(lambda: run(_gen(1000), y, N_NEST)), need)
    bodies = [u.steps_run - b for u, b in zip(unfolds, before)]
    maps = _boundary_since(maps)
    if len(syncs) > T_NEST - 1:
        raise AssertionError(f"{label}: {len(syncs)} host syncs, more than "
                             f"the {T_NEST - 1} ESS checks: {syncs}")
    from genparticlefilters_tpu_torch.core.tree import tree_leaves
    leaves = [l for l in tree_leaves(st.traces)
              if isinstance(l, torch.Tensor)]
    if any(l.device.type != "cuda" for l in leaves):
        raise AssertionError(f"{label}: a trace leaf off the card")
    lmls = np.array([float(g.log_ml_estimate(run(_gen(1010 + s), y, N_NEST)))
                     for s in range(4)])
    lim = 6 * lmls.std() / 2 + 0.05
    diff, far = abs(lmls.mean() - log_z), float(np.abs(lmls - log_z).max())
    if diff >= lim or far >= 0.5:
        raise AssertionError(f"{label}: LMLs {lmls} vs exact log Z {log_z}")
    print(f"[{label} {shape}] one run: {len(syncs)} host syncs (limit "
          f"{T_NEST - 1}, the ESS checks), Unfold step bodies "
          f"{' + '.join(map(str, bodies))} (outer{', inner' if shape == 'N3' else ''}), "
          f"{maps['calls']} per-particle maps ({maps['copies']} boundary "
          f"copies); 4 seeds: mean LML {lmls.mean():.4f} vs exact log Z "
          f"{log_z:.4f} (|diff| {diff:.4f}, limit {lim:.4f}; farthest seed "
          f"{far:.4f}, limit 0.5)")
    return counts


def _mesh_setup():
    """The one-rank NCCL mesh of path 4w (the backend a multi-card run
    uses; NCCL takes one rank per card), made once per process."""
    import socket
    import torch.distributed as dist
    import genparticlefilters_tpu_torch as g
    if not dist.is_initialized():
        with socket.socket() as s:
            s.bind(("localhost", 0))
            port = s.getsockname()[1]
        torch.cuda.set_device(0)
        dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}",
                                world_size=1, rank=0)
    return g.parallel.particle_mesh()


def _mesh_run(y_obs, mesh=None):
    """``dryrun_multichip``'s step (__graft_entry__.py:64-95) at full width
    as ``run(gen, _, n)``: object motion, T=10, each step an update, the
    ESS-triggered blockwise resample with a ring rotation and a shuffle,
    MH on ``moving``, the exact global resample and a translator update
    (4 steps, two updates each). With ``mesh``, on the sharded state."""
    import genparticlefilters_tpu_torch as g
    from genparticlefilters_tpu_torch.models.object_motion import (
        make_object_motion, init_state, obs_dense)
    from genparticlefilters_tpu_torch.utils.spans import span
    model = make_object_motion(T_MAIN)
    kw = {} if mesh is None else {"mesh": mesh}

    @g.gen
    def flip(tr, t):
        g.trace((t, "moving"), g.bernoulli(0.5))
    flip.batch_safe = True

    def run(gen, _y, n, record=None):
        x0 = init_state("cuda")
        obs = obs_dense(y_obs)
        steps = torch.arange(T_MAIN, device="cuda")
        with span("mw.initialize"):
            st = g.pf_initialize(gen, model, (1, x0), obs, n)
            if mesh is not None:
                st = g.parallel.shard_state(st, mesh)
        for t in range(1, T_MAIN - 1, 2):
            with span("mw.update"):
                st = g.pf_update(gen, st, (t + 1, x0),
                                 (g.UnknownChange(), g.NoChange()), obs,
                                 check=False)
            with span("mw.ess_check"):
                ess = g.effective_sample_size(st)
                low = bool(ess < 0.75 * n)
            if low:
                with span("mw.blockwise"), _DistCalls() as calls:
                    before = _mesh_collectives()
                    st = g.pf_resample_blockwise(gen, st, 1, "systematic",
                                                 **kw)
                    if record is not None:
                        record.append(_mesh_collectives() - before
                                      + calls.count)
                with span("mw.exchange"):
                    st = g.pf_rotate_blocks(st, 1, 1, **kw)
                    st = g.pf_shuffle_blocks(st, 1, **kw)
            sel = g.Selection({("moving",): steps == t, ("y",): steps == t})
            with span("mw.rejuvenate"):
                st = g.pf_rejuvenate(gen, st, g.mh, (sel,))
            with span("mw.resample"):
                st = g.pf_resample(gen, st, "systematic", check=False)
            with span("mw.translate"):
                st = g.pf_update(gen, st, (t + 2, x0),
                                 (g.UnknownChange(), g.NoChange()), obs,
                                 proposal=flip, proposal_args=(t + 1,),
                                 check=False)
            if record is not None:
                record.append(("ess", ess, low))
        return st
    return run


class _DistCalls:
    """Counts every call of torch.distributed's collectives and
    point-to-point functions while active (``isend``/``irecv`` are named
    by a ``P2POp`` and run by ``batch_isend_irecv``, counted here)."""
    NAMES = ("all_gather", "all_gather_into_tensor", "all_gather_object",
             "all_reduce", "all_to_all", "all_to_all_single", "broadcast",
             "batch_isend_irecv", "send", "recv", "reduce", "reduce_scatter",
             "scatter", "gather", "barrier")

    def __enter__(self):
        import torch.distributed as dist
        self.count, self.saved = 0, {}
        for name in self.NAMES:
            fn = getattr(dist, name, None)
            if fn is None:
                continue
            self.saved[name] = fn

            def wrapped(*a, _fn=fn, **k):
                self.count += 1
                return _fn(*a, **k)
            setattr(dist, name, wrapped)
        return self

    def __exit__(self, *exc):
        import torch.distributed as dist
        for name, fn in self.saved.items():
            setattr(dist, name, fn)
        return False


def _mesh_collectives():
    from genparticlefilters_tpu_torch.parallel.mesh import COLLECTIVES
    return sum(COLLECTIVES.values())


def _mesh_path(y_obs):
    """(w): the mesh step at world size 1 over NCCL at N=100K: the sharded
    run (launches, host syncs, collectives) and the same step with
    mesh=None from the same seed, bit-equal leaf by leaf; each blockwise
    resample made no collective and no torch.distributed call."""
    import genparticlefilters_tpu_torch as g
    from genparticlefilters_tpu_torch.interop import state_to_numpy
    from genparticlefilters_tpu_torch.parallel.mesh import COLLECTIVES
    mesh = _mesh_setup()
    rec_m, rec_p = [], []
    before = dict(COLLECTIVES)
    with _DistCalls() as calls:
        (st, syncs), counts = _path(
            f"4w mesh step (NCCL, world 1) N={N_MAIN} T={T_MAIN}",
            lambda: _synced(lambda: _mesh_run(y_obs, mesh)(
                _gen(1100), None, N_MAIN, rec_m)), (G1,))
    coll = {k: COLLECTIVES[k] - before[k] for k in before}
    plain = _mesh_run(y_obs)(_gen(1100), None, N_MAIN, rec_p)
    torch.cuda.synchronize()
    a, b = state_to_numpy(st), state_to_numpy(plain)
    if len(a) != len(b) or not all(np.array_equal(x, y) for x, y in zip(a, b)):
        raise AssertionError("4w: the sharded step and mesh=None differ")
    ess_m = [r for r in rec_m if isinstance(r, tuple)]
    ess_p = [r for r in rec_p if isinstance(r, tuple)]
    if [x[2] for x in ess_m] != [y[2] for y in ess_p]:
        raise AssertionError(f"4w: ESS branches differ: {ess_m} / {ess_p}")
    ess_bits = all(float(x[1]) == float(y[1]) for x, y in zip(ess_m, ess_p))
    block_colls = [r for r in rec_m if not isinstance(r, tuple)]
    if not block_colls or any(block_colls):
        raise AssertionError(f"4w: blockwise resamples {len(block_colls)}, "
                             f"collectives and torch.distributed calls in "
                             f"them {block_colls}")
    # per step: the ESS check, and the global resample's one host read of
    # the ranks' source ranges (flagged twice: the copy and its wait)
    n_steps = len(ess_m)
    if len(syncs) > 3 * n_steps:
        raise AssertionError(f"4w: {len(syncs)} host syncs for {n_steps} "
                             f"steps: {syncs}")
    lml_m = float(g.log_ml_estimate(st))
    lml_p = float(g.log_ml_estimate(plain))
    print(f"[4w mesh] {mesh!r}: {n_steps} steps, ESS branch taken "
          f"{sum(x[2] for x in ess_m)} times; {len(block_colls)} blockwise "
          f"resamples with 0 collectives and 0 torch.distributed calls "
          f"(calls in the whole run {calls.count}, by kind {coll}); "
          f"{len(syncs)} flagged synchronizing calls (limit {3 * n_steps}: "
          f"per step the ESS check and the global resample's one read of the "
          f"source ranges, a copy and its wait); "
          f"every leaf bit-equal to the mesh=None run from the same seed; "
          f"global ESS bit-equal {ess_bits}; LML {lml_m!r} sharded, "
          f"{lml_p!r} mesh=None")
    return counts


def _nested_paths():
    """Paths (t)-(w); returns the launch counts of each."""
    seen = {"4t": _nested_path("N1", "4t", (G1,)),
            "4u": _nested_path("N2", "4u", (G1, G2)),
            "4v": _nested_path("N3", "4v", (G1,)),
            "4v pp": _nested_path("N3", "4v per particle", (G1,),
                                  batch_safe=False)}
    seen["4w"] = _mesh_path(_data())
    return seen


# ---------------------------------------------------------------------------
# Path 4x: the compiled drivers, each filter run one captured CUDA graph
# ---------------------------------------------------------------------------

X_FORCE = 1.5        # an ess_frac above 1: ESS < 1.5·N at every step, so
#                      every ESS branch fires
X_KERNELS = {G1: "stairs_gather_kernel", G2: "stairs_gather_u_kernel"}


def _reseeded(run, gen, take=lambda out: out):
    """``(gen_, y, n) -> state``: the captured ``run`` replayed with its
    registered generator ``gen`` reseeded to ``gen_``'s seed (the form
    the eager gates call)."""
    def replay(gen_, _y, _n):
        gen.manual_seed(gen_.initial_seed())
        return take(run())
    return replay


def _bit_equal(a, b):
    """None where every leaf of ``a`` and ``b`` is bit-equal, else the
    first leaf that differs."""
    from genparticlefilters_tpu_torch.core.tree import tree_flatten
    la, lb = tree_flatten(a)[0], tree_flatten(b)[0]
    if len(la) != len(lb):
        return f"{len(la)} leaves against {len(lb)}"
    for i, (x, y) in enumerate(zip(la, lb)):
        if isinstance(x, torch.Tensor):
            if x.dtype != y.dtype or not torch.equal(x, y):
                return f"leaf {i} ({x.dtype} {tuple(x.shape)})"
        elif x != y:
            return f"leaf {i} ({x!r} against {y!r})"
    return None


X_FORMS = ("donated", "buffered", "select")


def _x_capture_forms(fn, args, kw, seed):
    """({form: (run, its generator)}, the launch counts of the first
    capture): ``fn`` captured as it ships (each device_cond an IF node that
    donates the state), under capture's private ``_buffered_form`` (every
    replaced leaf buffered, each node with an ELSE body) and under
    ``_select_form`` (each a device select), each on a generator seeded
    ``seed``; the counts are set to 0 just before the first capture and
    read just after it."""
    from genparticlefilters_tpu_torch import capture
    cm = _capture_module()
    forms = {"donated": contextlib.nullcontext,
             "buffered": cm._buffered_form, "select": cm._select_form}
    runs, counts = {}, None
    _reset_counts()
    for form, ctx in forms.items():
        gen = _gen(seed)
        with ctx():
            runs[form] = (capture(fn, gen, *args, **kw), gen)
        torch.cuda.synchronize()
        counts = counts or _counts()
    return runs, counts


def _x_same(runs, seed):
    """(g): each form's replay from one seed against the donated one's:
    {form: None where bit-equal, else the first leaf that differs}."""
    outs = {}
    for form, (run, gen) in runs.items():
        gen.manual_seed(seed)
        outs[form] = run()
    torch.cuda.synchronize()
    return {form: _bit_equal(outs["donated"], out)
            for form, out in outs.items() if form != "donated"}


def _x_said(diff):
    return "bit-equal" if diff is None else "differs at " + diff


def _x_copies(run):
    """(taken checks, copy_leaves launches due) of the last replay of
    ``run``: each IF node's predicate as that replay read it; a taken
    check launches one copy (THEN), an untaken one a copy only where its
    node buffers leaves (ELSE)."""
    taken = [bool(n.pred) for n in run.bodies.nodes]
    return sum(taken), sum(t or n.buffered > 0
                           for t, n in zip(taken, run.bodies.nodes))


X_SEEDS = range(971, 987)     # where (d) looks for a replay that resampled


def _x_fired_seed(run, gen, take):
    """The first seed of ``X_SEEDS`` whose replay resampled at some step
    (the state's parents are not the identity): there an ESS branch was
    taken, so its kernels ran in a THEN body. The last seed where none
    did (then (d) finds no G1 and fails)."""
    for seed in X_SEEDS:
        gen.manual_seed(seed)
        parents = take(run()).parents
        if not torch.equal(parents, torch.arange(
                parents.shape[0], device=parents.device,
                dtype=parents.dtype)):
            return seed
    return seed


def _x_forced(label, fn, args, kw, keep, seed=970):
    """(a) and (g) with every branch forced: the donated IF replay from a
    fresh seed against the eager run from the same seed and against the
    buffered and select replays from it, leaf for leaf, and two donated
    replays from one seed against each other. Returns what differed, or
    None; the runs go into ``keep``."""
    kw = dict(kw, ess_frac=X_FORCE)
    runs, _ = _x_capture_forms(fn, args, kw, 0)
    keep += [r for r, _ in runs.values()]
    run, gen = runs["donated"]
    eager = fn(_gen(seed), *args, **kw)
    gen.manual_seed(seed)
    first = run()
    gen.manual_seed(seed)
    second = run()
    torch.cuda.synchronize()
    vs_eager, vs_replay = _bit_equal(first, eager), _bit_equal(first, second)
    vs = _x_same(runs, seed)
    # every body taken: each IF replay does the select's work, so the
    # profiler must see as much device time in it (the kernels inside
    # the THEN bodies included)
    prof = {form: _x_profile(r) for form, (r, _) in runs.items()}
    busy = {form: p[1] for form, p in prof.items()}
    print(f"[4x {label} (a), (g)] every branch forced (ess_frac {X_FORCE}), "
          f"seed {seed}: donated IF replay against eager "
          f"{_x_said(vs_eager)}; two donated replays {_x_said(vs_replay)}; "
          f"against the buffered replay {_x_said(vs['buffered'])}, the "
          f"select replay {_x_said(vs['select'])}; profiled device busy "
          + ", ".join(f"{k} {v:.3f} ms" for k, v in busy.items())
          + "; " + _x_where(prof, "donated", "select"))
    if vs_eager or vs_replay or vs["buffered"] or vs["select"]:
        return (f"4x {label} (a)/(g) forced: donated replay against eager "
                f"{vs_eager}, against a donated replay {vs_replay}, against "
                f"the buffered replay {vs['buffered']}, against the select "
                f"replay {vs['select']}")
    return None


def _x_profile(run, reseed=lambda: None, tries=2):
    """One run under torch.profiler: of ``tries`` profiled runs after a
    profiled warm-up run, the one with the most kernels (a profile in a
    long process drops records: once a third of the replay's kernels,
    1,206 of the headline's ~1,980, once all but 4 of config 2's):
    (kernels, device busy ms, {kernel name: count}, {kernel name: busy
    ms}). ``reseed`` runs before each run."""
    from torch.profiler import profile, ProfilerActivity
    cuda = torch.autograd.DeviceType.CUDA
    best = None
    for i in range(tries + 1):
        reseed()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA],
                     acc_events=True) as prof:
            run()
            torch.cuda.synchronize()
        if i == 0:
            continue
        kern = [e for e in prof.key_averages() if e.device_type == cuda
                and not e.key.startswith(SPANS)]
        got = (sum(e.count for e in kern),
               sum(e.self_device_time_total for e in kern) / 1e3,
               {e.key: e.count for e in kern},
               {e.key: e.self_device_time_total / 1e3 for e in kern})
        if best is None or got[0] > best[0]:
            best = got
    return best


def _x_where(prof, a, b, top=6):
    """Where the device time of profile ``a`` differs from ``b``'s: the
    ``top`` kernel names by |busy ms a - b|, with their counts."""
    pa, pb = prof[a], prof[b]
    names = sorted(set(pa[3]) | set(pb[3]), key=lambda n: -abs(
        pa[3].get(n, 0.0) - pb[3].get(n, 0.0)))[:top]
    return f"{a} - {b} by kernel: " + "; ".join(
        f"{n.split('(')[0][:40]} {pa[3].get(n, 0.0) - pb[3].get(n, 0.0):+.4f}"
        f" ms (x{pa[2].get(n, 0)} / x{pb[2].get(n, 0)})" for n in names)


def _x_turns(fns, reps=5):
    """``fns`` ({label: fn}) timed in turns on the host clock, each run
    ending in a synchronize: {label: (median, min, max)} ms of ``reps``
    runs after one warm-up."""
    times = {k: [] for k in fns}
    for _ in range(reps + 1):
        for k, fn in fns.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times[k].append((time.perf_counter() - t0) * 1e3)
    return {k: (statistics.median(v[1:]), min(v[1:]), max(v[1:]))
            for k, v in times.items()}


def _x_cell(label, fn, args, kw, need, checks, gate, card, keep, last,
            take=lambda out: out):
    """One 4x cell: at the default ess_frac the capture in the three forms
    (time, pool memory, the kernels captured as graph nodes, the IF nodes:
    one per ESS check; those with an ELSE body, the leaves donated and
    buffered), (g) the donated IF replay bit-equal to the buffered and
    select replays from one seed, (b) the eager cell's gate on donated
    replays, (c) host syncs per IF replay against the eager run's, (e)
    ms/run of the donated, buffered and select replays and the eager run
    in turns, (d) one profiled run of each, the donated replay's showing
    device time, each kernel of ``need`` and as many copy_leaves kernels as
    its checks call for (one per taken check, plus one per untaken check
    whose node buffers); then (a) and (g) forced. Returns the launch
    counts at the donated capture. Every captured run goes into ``keep``;
    the ``last`` cell empties it before its forced runs, since no profile
    follows."""
    from genparticlefilters_tpu_torch.ops.graph_cond import copy_leaves_runs
    runs, counts = _x_capture_forms(fn, args, kw, 1)
    keep += [r for r, _ in runs.values()]
    run, gen = runs["donated"]
    missing = [k for k in need + (GC, CL) if counts[k] < 1]
    if missing:
        raise AssertionError(f"4x {label}: {missing} not captured")
    shape = {f: r.forms for f, (r, _) in runs.items() if f != "select"}
    print(f"[4x {label} (f)] " + "; ".join(
        f"{f} form captured in {r.capture_seconds * 1e3:.1f} ms, pool "
        f"{r.pool_bytes / 2**20:.1f} MiB, IF nodes {r.nodes}"
        + (f" (with an ELSE body {shape[f]['else_nodes']}; leaves donated "
           f"{shape[f]['donated']}, buffered {shape[f]['buffered']})"
           if f in shape else "") for f, (r, _) in runs.items())
          + f" (warm-up not counted; pool: torch.cuda.max_memory_allocated "
          f"past what was allocated before; {checks} ESS checks per run); "
          f"kernel launches in the donated capture's warm-up and capture "
          f"(one program; the capture's are graph nodes): {_short(counts)}")
    if (runs["donated"][0].nodes != checks or runs["buffered"][0].nodes
            != checks or runs["select"][0].nodes != 0
            or shape["buffered"]["else_nodes"] != checks
            or shape["buffered"]["donated"] != 0):
        raise AssertionError(f"4x {label}: IF nodes donated / buffered / "
                             f"select {[r.nodes for r, _ in runs.values()]} "
                             f"for {checks} ESS checks; forms {shape}")
    vs = _x_same(runs, 971)
    print(f"[4x {label} (g)] ess_frac as the cell runs, seed 971: donated "
          f"IF replay against the buffered replay {_x_said(vs['buffered'])}"
          f", against the select replay {_x_said(vs['select'])}")
    gate(_reseeded(run, gen, take))
    syncs = {f: len(_synced(runs[f][0])[1]) for f in ("donated", "buffered")}
    _, eager_syncs = _synced(lambda: fn(_gen(401), *args, **kw))
    if any(syncs.values()):
        raise AssertionError(f"4x {label}: host syncs per replay {syncs}")
    eager = lambda: fn(_gen(402), *args, **kw)  # noqa: E731
    wall = _x_turns({**{f: r for f, (r, _) in runs.items()},
                     "eager": eager})
    seed = _x_fired_seed(run, gen, take)
    prof, ran = {}, {}
    for f, (r, g) in runs.items():
        # the kernel's counter on the card, set to 0 before each run: it
        # holds the profiled replay's copy_leaves launches after it
        prof[f] = _x_profile(r, lambda g=g: (g.manual_seed(seed),
                                             copy_leaves_runs(reset=True)))
        ran[f] = copy_leaves_runs()
    copies = {f: _x_copies(runs[f][0]) for f in ("donated", "buffered")}
    prof["eager"] = _x_profile(lambda: fn(_gen(seed), *args, **kw))
    launched = {f: sum(c for n, c in prof[f][2].items()
                       if n.startswith("copy_leaves_kernel("))
                for f in copies}
    # a profiler key is the demangled signature: "stairs_gather_kernel(...)"
    missing = [k for k in need if not any(
        n.startswith(X_KERNELS[k] + "(") for n in prof["donated"][2])]
    print(f"[4x {label}] (c) host syncs per replay, donated "
          f"{syncs['donated']}, buffered {syncs['buffered']}, eager "
          f"{len(eager_syncs)}; (e) ms/run, median of 5 after a warm-up, in "
          f"turns (min, max); (d) one profiled run each from seed {seed}, the "
          f"first from {X_SEEDS[0]} whose donated replay resampled: kernels, "
          f"device busy ms, idle share (1 - busy / median ms): " + "; ".join(
              f"{k} {wall[k][0]:.3f} ms ({wall[k][1]:.3f}, {wall[k][2]:.3f}), "
              f"{prof[k][0]} kernels, busy {prof[k][1]:.3f} ms, idle "
              f"{1 - prof[k][1] / wall[k][0]:.3f}" for k in wall)
          + "; busy over eager's: " + ", ".join(
              f"{f} {prof[f][1] - prof['eager'][1]:+.3f} ms "
              f"({prof[f][0] - prof['eager'][0]:+d} kernels)"
              for f in ("donated", "buffered", "select"))
          + f"; eager / donated {wall['eager'][0] / wall['donated'][0]:.2f}x"
          f", buffered / donated "
          f"{wall['buffered'][0] / wall['donated'][0]:.2f}x, select / "
          f"donated {wall['select'][0] / wall['donated'][0]:.2f}x; card "
          f"{card}")
    print(f"[4x {label} (d)] copy_leaves runs in the profiled replay, "
          f"counted on the card: " + ", ".join(
              f"{f} {ran[f]} (taken checks {copies[f][0]} of {checks}, "
              f"copies due {copies[f][1]}; the profiler saw {launched[f]})"
              for f in copies) + f", select {ran['select']}"
          + f"; {need[0].split()[0]} kernels (one per resample) "
          + ", ".join(f"{f} {p[2].get(n, 0)}" for f, p in prof.items()
                      for n in p[2] if n.startswith(X_KERNELS[need[0]] + "("))
          + "; " + _x_where(prof, "donated", "eager") + "; "
          + _x_where(prof, "donated", "buffered"))
    kernels, busy, names, _ = prof["donated"]
    print(f"[4x {label}] device memory reserved after (d) "
          f"{torch.cuda.memory_reserved() / 2**30:.2f} GiB (every captured "
          f"run of 4x kept so far)")
    if last:
        del run, runs
        keep.clear()
        gc.collect()
        torch.cuda.empty_cache()
    forced = _x_forced(label, fn, args, kw, keep)
    if busy <= 0 or missing:
        raise AssertionError(f"4x {label}: the profiled donated replay shows "
                             f"{kernels} kernels, {busy:.3f} ms busy, no "
                             f"{missing} kernel: " + ", ".join(
                                 f"{n[:48]} x{c}" for n, c in names.items()))
    wrong = {f: (ran[f], copies[f][1]) for f in copies
             if ran[f] != copies[f][1]}
    if wrong or ran["select"]:
        raise AssertionError(f"4x {label}: copy_leaves runs in the "
                             f"profiled replay against the copies due: "
                             f"{wrong}, select {ran['select']}")
    if forced is not None:
        raise AssertionError(forced)
    if vs["buffered"] or vs["select"]:
        raise AssertionError(f"4x {label} (g): the donated replay differs "
                             f"from the buffered replay at "
                             f"{vs['buffered']}, from the select replay at "
                             f"{vs['select']}")
    return counts


def _mot_gate(label, replay, y):
    """Four seeds of config 5's filter: each posterior mean at the last
    step within 3 observation sds of the last observation."""
    errs = [_mot_posterior_check(label, replay(_gen(520 + s), y, N_C5), y,
                                 T_C5) for s in range(4)]
    print(f"[{label}] 4 seeds at N={N_C5} T={T_C5}: posterior mean max "
          f"|x - y_last| {max(errs):.4f} (limit 1.5)")


def _captured_paths(y_obs):
    """(x): the headline (N=100K and 1M, systematic and residual), config 2,
    4k SV, 4l tempered and config 5's filter, each run captured once and
    replayed; returns the launch counts at capture of each."""
    from torch.profiler import profile, ProfilerActivity
    from genparticlefilters_tpu_torch.models.object_motion import (
        object_motion_filter_impl)
    from genparticlefilters_tpu_torch.models.tempered import run_tempered_smc
    from genparticlefilters_tpu_torch.models.stochastic_volatility import (
        sv_particle_filter)
    from genparticlefilters_tpu_torch.models.linear_gaussian import (
        lgssm_particle_filter)
    from genparticlefilters_tpu_torch.models.multi_object import (
        MOTParams, mot_particle_filter)
    # the profiler records a graph's kernel nodes only where it had started
    # in this process before the graph was captured: start it once first
    with profile(activities=[ProfilerActivity.CUDA]):
        torch.ones(1, device="cuda").add_(1)
        torch.cuda.synchronize()
    card = _card_line()
    p, y, _ = _sv_setup()
    p_lg, y_lg, kalman = _lg_setup()
    y_mot = _mot_data(T_C5)
    cells = []
    for n in (N_MAIN, 1_000_000):
        for method, need in (("systematic", (G1,)), ("residual", (G1, G2))):
            label = f"headline {method} N={n} T={T_MAIN}"
            cells.append((label, object_motion_filter_impl, (y_obs, n, T_MAIN),
                          {"resample_method": method}, need, T_MAIN - 1,
                          lambda replay, n=n, label=label: _posterior_check(
                              replay, y_obs, n, f"4x {label}"), {}))
    cells.append((f"config 2 N={N_LG} T={T_LG}", lgssm_particle_filter,
                  (y_lg, N_LG, T_LG, p_lg), {"resample_method": "systematic"},
                  (G1,), T_LG - 1, lambda replay: _lg_gate(
                      "4x config 2", [replay(_gen(10 + s), y_lg, N_LG)
                                      for s in range(4)], kalman), {}))
    label = f"4k SV N={N_SV} T={T_SV}"
    cells.append((label, sv_particle_filter, (y, N_SV, T_SV, p),
                  {"rejuv_window": 2}, (G1,), T_SV - 1,
                  lambda replay: _sv_lml_gate("4x 4k SV", replay, y, p), {}))
    label = f"4l tempered N={N_TM} K={K_TM}"
    cells.append((label, run_tempered_smc, (N_TM,),
                  {"n_temps": K_TM, "rejuv_iters": 2}, (G1,), K_TM - 1,
                  lambda replay: _tm_lml_gate("4x 4l tempered", replay, 840),
                  {"take": lambda out: out[0]}))
    cells.append((f"config 5 N={N_C5} T={T_C5}", mot_particle_filter,
                  (y_mot, N_C5, T_C5, MOTParams()),
                  {"resample_method": "systematic"}, (G1,), T_C5 - 1,
                  lambda replay: _mot_gate("4x config 5", replay, y_mot), {}))
    # every cell runs and prints what it measured before any failure is
    # raised: the failures are listed together at the end
    seen, failed, keep = {}, [], _KEPT
    for i, (label, fn, args, kw, need, checks, gate, extra) in enumerate(
            cells):
        try:
            seen[f"4x {label}"] = _x_cell(label, fn, args, kw, need, checks,
                                          gate, card, keep,
                                          i == len(cells) - 1, **extra)
        except Exception as e:              # re-raised below, all together
            print(f"[4x {label}] FAILED:\n{traceback.format_exc()}")
            failed.append(f"{label}: {type(e).__name__}: {e}")
    keep.clear()
    gc.collect()
    torch.cuda.empty_cache()
    if failed:
        raise AssertionError("4x: " + " | ".join(failed))
    return seen


def _line_step_bodies(card):
    """The Unfold step bodies one run of each 4o route executes: route A's
    full re-scans grow with t (O(T²) per run), route B's extension runs
    one per new step (O(T)); the MH re-scans are the same in both."""
    model, unfold, y = _line_setup()
    for route in ("A", "B"):
        before = unfold.steps_run
        _line_run(route, model)(_gen(910), y, N_LINE)
        print(f"[5 4o route {route}] Unfold step bodies per run "
              f"{unfold.steps_run - before} (N={N_LINE}, T={T_LINE}); card "
              f"{card}")


def _config34_rows(y_obs):
    """(label, run, y, n, syncs allowed) of the cells timed together: the
    object-motion filter (systematic, N=100K) beside configs 3 and 4, the
    call-site cells 4o and 4p, the nested cells 4t-4v and the mesh step
    4w, so a slow host shows in all of them and a slow cell alone."""
    _, y, sv_run = _sv_setup()
    line_model, _, y_line = _line_setup()
    return [(f"object motion systematic N={N_MAIN} T={T_MAIN}",
             _filter("systematic"), y_obs, N_MAIN, MAX_SYNCS),
            (f"config 3 SV N={N_SV} T={T_SV}", sv_run, y, N_SV, T_SV - 1),
            (f"config 4 tempered N={N_TM} K={K_TM}", _tm_run, None, N_TM,
             K_TM - 1),
            (f"config 4 SMCP3 N={N_TM} K={K_TM}", _smcp3_run, None, N_TM,
             K_TM - 1),
            (f"4o line model route A N={N_LINE} T={T_LINE}",
             _line_run("A", line_model), y_line, N_LINE, T_LINE),
            (f"4o line model route B N={N_LINE} T={T_LINE}",
             _line_run("B", line_model), y_line, N_LINE, T_LINE),
            (f"4p plate N={N_PLATE} n={D_PLATE}", _plate_run(_plate_setup()),
             None, N_PLATE, 0)] + [
            (f"{cell} {shape} N={N_NEST} T={T_NEST}",
             _nested_run(shape, _nested_models()[shape][0]),
             _nested_data(shape), N_NEST, T_NEST - 1)
            for cell, shape in (("4t", "N1"), ("4u", "N2"), ("4v", "N3"))] + [
            (f"4w mesh step (NCCL, world 1) N={N_MAIN}",
             _mesh_run(y_obs, _mesh_setup()), None, N_MAIN, 12)]


def _host_state():
    """What this process carries that could slow its host side: objects
    the cyclic GC tracks, and the caching allocator's reserved memory."""
    return (f"{len(gc.get_objects()):,} GC-tracked objects, "
            f"{torch.cuda.memory_reserved() / 2**30:.2f} GiB reserved")


def _config34_wall(card, when, y_obs, variants=("as is",)):
    """ms per run of the ``_config34_rows`` cells, in turns run by run
    (median of 5 after a warm-up, min-max), under each of ``variants``:
    "as is", "gc off" (the cyclic GC disabled while timing) and "empty
    cache" (the allocator's cache emptied first). Returns {label: ms} of
    "as is"."""
    rows = _config34_rows(y_obs)
    gen = _gen(900)
    out = {}
    for variant in variants:
        if variant == "empty cache":
            torch.cuda.empty_cache()
        state = _host_state()
        times = {r[0]: [] for r in rows}
        if variant == "gc off":
            gc.disable()
        try:
            for _ in range(6):
                for label, run, yy, n, _ in rows:
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    run(gen, yy, n)
                    torch.cuda.synchronize()
                    times[label].append((time.perf_counter() - t0) * 1e3)
        finally:
            gc.enable()
        for label, r in times.items():
            r = r[1:]                       # the first run warms up
            med = statistics.median(r)
            if variant == "as is":
                out[label] = med
            print(f"[5 wall {when}, {variant}] {label}: {med:.3f} ms/run "
                  f"(median of 5 after a warm-up, cells in turns; min "
                  f"{min(r):.3f}, max {max(r):.3f}); {state}; card {card}")
    return out


def _config34_timing(card, y_obs):
    """Configs 3 and 4 (4k, 4l, 4m): ms per run beside object motion, with
    the GC off and after emptying the allocator's cache, a profiler
    breakdown, host syncs of one run and G1's launches per run; then the
    store copy of each windowed SV rejuvenation."""
    import genparticlefilters_tpu_torch as g
    rows = _config34_rows(y_obs)[1:]
    wall = _config34_wall(card, "after config 5", y_obs,
                          ("as is", "gc off", "empty cache"))
    gen = _gen(900)
    spans = {}
    for label, run, yy, n, max_syncs in rows:
        _reset_counts()
        run(gen, yy, n)
        torch.cuda.synchronize()
        print(f"[5 {label}] G1 launches per run {_counts()[G1]}; card {card}")
        spans[label] = _profile_filter(run, yy, n, wall[label] / 1e3, label,
                                       card)
        total, top = _sync_count(run, yy, n)
        print(f"[5 syncs] {label}: {total} synchronizing CUDA calls in one "
              f"run (limit {max_syncs}: the ESS checks, and on 4w the global "
              f"resample's read of its source ranges); by call site: {top}")
        if total > max_syncs:
            raise AssertionError(f"{label}: {total} host syncs per run, more "
                                 f"than the limit {max_syncs}")
    _line_step_bodies(card)
    for n in (N_MAIN, 1_000_000):
        w = torch.rand(n, generator=gen, device="cuda")
        w = w / w.sum()
        dev, _ = _timed({"float32": lambda: torch.cumsum(w, 0),
                         "float64": lambda: torch.cumsum(
                             w, 0, dtype=torch.float64)})
        print(f"[5 scan] the weights' cumsum at n={n}: float32 "
              f"{dev['float32']:.4f} ms, float64 (what resampling now "
              f"runs) {dev['float64']:.4f} ms device time (20 queued "
              f"calls, median of 12); card {card}")
    _, y, sv_run = _sv_setup()
    st = sv_run(gen, y, N_SV)
    steps = torch.arange(T_SV, device="cuda")
    sel = g.Selection({("h",): steps == T_SV - 1})
    mat = st.traces.inner["store"].mat
    dev, call = _timed({
        "pf_move_reweight": lambda: g.pf_move_reweight(
            gen, st, g.move_reweight, (sel,), window=2),
        "store copy": lambda: mat.clone()})
    nbytes = 2 * mat.numel() * mat.element_size()
    n_rejuv = spans[rows[0][0]].get("sv.rejuvenate", 0)
    print(f"[5 store copy] config 3: each windowed rejuvenation copies the "
          f"packed store mat {tuple(mat.shape)} int32 ({nbytes / 1e6:.1f} MB "
          f"read+written): copy {dev['store copy']:.4f} ms device time "
          f"(bound {nbytes / HBM_BYTES_PER_MS:.4f} ms) of "
          f"{dev['pf_move_reweight']:.4f} ms for the whole pf_move_reweight "
          f"(20 queued calls, median of 12); one call with the host in the "
          f"loop {call['pf_move_reweight']:.4f} ms; x {n_rejuv} rejuvenations"
          f" (sv.rejuvenate spans of the profiled run) = "
          f"{n_rejuv * dev['store copy']:.3f} ms per run; card {card}")


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


def _timed(fns, reps=6):
    """``fns`` ({label: fn}) timed in turns, forward then backward order,
    ``reps`` times: the medians of the device time per call (20 calls
    queued) and of one call with the host in the loop, each {label: ms}."""
    for _ in range(3):
        for fn in fns.values():
            fn()
    torch.cuda.synchronize()
    order = list(fns) + list(fns)[::-1]
    dev = {k: [] for k in fns}
    call = {k: [] for k in fns}
    for _ in range(reps):
        for k in order:
            dev[k].append(_queued_ms(fns[k]))
            call[k] += _event_ms(fns[k], 2)
    med = statistics.median
    return ({k: med(v) for k, v in dev.items()},
            {k: med(v) for k, v in call.items()})


def _compare_timing(label, kern, plain, card, nbytes, library=None):
    """Kernel against plain and, where one PyTorch call computes the same
    function, that call (``library``), in turns; the bound is ``nbytes``
    (each input read once, each output written once) over 3.35 TB/s."""
    fns = {"kernel": kern, "plain": plain}
    if library is not None:
        fns["library"] = library
    dev, call = _timed(fns)
    bound = nbytes / HBM_BYTES_PER_MS
    lib_dev, lib_call = (
        (f", library {dev['library']:.4f} ms", f", library "
         f"{call['library']:.4f} ms") if library else ("", ""))
    print(f"[5 {label}: device time per call (20 queued calls, median of "
          f"12) kernel {dev['kernel']:.4f} ms ({nbytes / 1e6:.2f} MB at "
          f"{nbytes / 1e6 / dev['kernel']:.0f} GB/s; bound {bound:.5f} ms, "
          f"share {bound / dev['kernel']:.3f}), plain {dev['plain']:.4f} ms"
          f"{lib_dev}; one call with the host in the loop (median of 12) "
          f"kernel {call['kernel']:.4f} ms, plain {call['plain']:.4f} ms"
          f"{lib_call}; card {card}")
    return {"ms": dev["kernel"], "plain_ms": dev["plain"],
            "library_ms": dev.get("library"), "bound_ms": bound}


def _clustered_parents(n, dev, gen):
    from genparticlefilters_tpu_torch.smc.resample import (systematic_F,
                                                           _F_to_parents)
    return _F_to_parents(
        systematic_F(gen, _weights("dirichlet", n, dev, gen)), n)


def _kernel_timing(n, card):
    """``{kernel: {ms, plain_ms, library_ms, bound_ms}}`` for G1, G2, G3
    (column and row mode), G4 and G5 at n particles."""
    from genparticlefilters_tpu_torch.ops.fused_gather import (
        resample_gather_split, resample_gather_split_plain,
        resample_gather_split_u, resample_gather_split_u_plain)
    from genparticlefilters_tpu_torch.ops.gather import (
        gather_cols, gather_cols_plain, gather_rows, gather_rows_plain)
    from genparticlefilters_tpu_torch.ops.max_scan import (max_scan,
                                                           max_scan_plain)
    from genparticlefilters_tpu_torch.ops.merge_count import (
        merge_count, merge_count_plain)
    from genparticlefilters_tpu_torch.smc.resample import systematic_F
    from smcbench.harness.devicetime import flushed_seconds
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)
    pieces = _pieces(WIDTHS, n, dev, gen)
    rows = sum(WIDTHS)
    F = systematic_F(gen, _weights("dirichlet", n, dev, gen))
    c, u = _brackets(n, n, "plain", dev, gen)
    c5_pieces = _pieces(WIDTHS_C5, n, dev, gen)
    c5_parents = _clustered_parents(n, dev, gen)
    # one [161, N] piece: index_select along the particle axis computes
    # G3's column-mode function at the row's total width
    c5_big, c5_idx = torch.cat(c5_pieces, 0), c5_parents.long()
    rows8 = _row_pieces((8,), n, dev, gen)
    perm = torch.randperm(n, generator=gen, device=dev).to(torch.int32)
    idx = perm.long()
    clustered8 = _clustered_parents(n, dev, gen)
    scans = {dt: _g5_input("cumsum", dt, (n,), gen, dev)
             for dt in (torch.float32, torch.int32)}
    g5 = {}
    for dt, x in scans.items():
        g5[dt] = _compare_timing(
            f"G5] N={n} {dt}", lambda: max_scan(x),
            lambda: max_scan_plain(x), card, 8 * n,
            lambda: torch.cummax(x, 0).values)
        alone = {k: 1e3 * flushed_seconds(f, dev) for k, f in (
            ("kernel", lambda: max_scan(x)),
            ("torch.cummax", lambda: torch.cummax(x, 0).values))}
        print(f"[5 G5] N={n} {dt}: one call alone, L2 flushed (median of "
              f"30): " + ", ".join(f"{k} {v:.4f} ms" for k, v in
                                   alone.items()) + f"; card {card}")
    _compare_timing(
        f"G3 row mode] N={n} [N, 8] clustered",
        lambda: gather_rows(rows8, clustered8),
        lambda: gather_rows_plain(rows8, clustered8), card,
        (2 * 8 + 1) * 4 * n,
        lambda: torch.index_select(rows8[0], 0, clustered8.long()))
    return {
        G3R: _compare_timing(
            f"G3 row mode] N={n} [N, 8] permutation",
            lambda: gather_rows(rows8, perm),
            lambda: gather_rows_plain(rows8, perm), card, (2 * 8 + 1) * 4 * n,
            lambda: torch.index_select(rows8[0], 0, idx)),
        G3: _compare_timing(
            f"G3] N={n} widths={WIDTHS_C5} clustered parents",
            lambda: gather_cols(c5_pieces, c5_parents),
            lambda: gather_cols_plain(c5_pieces, c5_parents), card,
            (2 * sum(WIDTHS_C5) + 1) * 4 * n,
            lambda: torch.index_select(c5_big, 1, c5_idx)),
        G1: _compare_timing(
            f"G1] N={n} widths={WIDTHS}",
            lambda: resample_gather_split(pieces, F),
            lambda: resample_gather_split_plain(pieces, F), card,
            (2 * rows + 2) * 4 * n),
        G2: _compare_timing(
            f"G2] N={n} widths={WIDTHS}",
            lambda: resample_gather_split_u(pieces, c, u),
            lambda: resample_gather_split_u_plain(pieces, c, u), card,
            (2 * rows + 3) * 4 * n),
        G4: _compare_timing(
            f"G4] n=m={n}", lambda: merge_count(c, u),
            lambda: merge_count_plain(c, u), card, 12 * n,
            lambda: torch.searchsorted(u, c, right=True, out_int32=True)),
        G5: g5[torch.float32]}


def _graph_cond_timing(card):
    """The toy's IF graphs, donated and buffered, each against its select
    graph, each replay one call, at both predicates; returns the donated
    untaken case's numbers. The bound is the function's own bytes: none
    but the predicate's byte untaken; taken, the two replaced leaves read
    once and their results written once (the draws are made, not read)."""
    out = {}
    for form in ("donated", "buffered"):
        run, sel, _, _, _ = _toy_runs(form)
        for p in (True, False):
            run(torch.tensor(p))
            sel(torch.tensor(p))
            out[form, p] = _compare_timing(
                f"graph_cond] toy device_cond, 3 x [{N_TOY}] state, {form} "
                f"form, predicate {p}: IF graph replay as kernel, select "
                f"graph replay as plain", run.graph.replay, sel.graph.replay,
                card, 4 * 4 * N_TOY if p else 1)
        _KEPT.extend((run, sel))
    return out["donated", False]


def _copy_leaves_timing(n, card):
    """copy_leaves on the headline's leaf set at n particles, held
    bit-equal to its plain version, then timed against it and against
    torch._foreach_copy_ (the one PyTorch call for the same copies, which
    the port never calls); the bound is each source read once and each
    destination written once."""
    from genparticlefilters_tpu_torch.ops.graph_cond import (
        copy_leaves, copy_leaves_plain)
    dev = torch.device("cuda")
    srcs = _leaf_set(n, dev, torch.Generator(device=dev).manual_seed(2))
    dsts = [torch.empty_like(x) for x in srcs]
    want = [torch.empty_like(x) for x in srcs]
    copy_leaves(dsts, srcs)
    copy_leaves_plain(want, srcs)
    torch.cuda.synchronize()
    if not all(torch.equal(_bytes(a), _bytes(b)) for a, b in zip(dsts, want)):
        raise AssertionError(f"copy_leaves differs from its plain version "
                             f"on the headline's leaf set at N={n}")
    nbytes = 2 * sum(x.numel() * x.element_size() for x in srcs)
    return _compare_timing(
        f"copy_leaves] N={n} the headline's 8 replaced leaves "
        f"(bit-equal to plain), library torch._foreach_copy_",
        lambda: copy_leaves(dsts, srcs),
        lambda: copy_leaves_plain(dsts, srcs), card, nbytes,
        lambda: torch._foreach_copy_(dsts, srcs))


G3R_TIMED = [(w, kind) for w in (1, 8, 16)
             for kind in ("permutation", "clustered")]


def _skewed_timing(card):
    """G4 at the skewed inputs and G3's row mode at widths 1, 8 and 16,
    each at 1M, against plain and the library call."""
    from genparticlefilters_tpu_torch.ops.gather import (gather_rows,
                                                         gather_rows_plain)
    from genparticlefilters_tpu_torch.ops.merge_count import (
        merge_count, merge_count_plain)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(2)
    for n, m, kind in G4_SKEWED:
        c, u = _g4_inputs(n, m, kind, dev, gen)
        _compare_timing(f"G4] n={n} m={m} {kind}", lambda: merge_count(c, u),
                        lambda: merge_count_plain(c, u), card,
                        8 * n + 4 * m,
                        lambda: torch.searchsorted(u, c, right=True,
                                                   out_int32=True))
    for w, kind in G3R_TIMED:
        x = _row_pieces((w,), N_C5, dev, gen)
        par = (torch.randperm(N_C5, generator=gen, device=dev).to(torch.int32)
               if kind == "permutation"
               else _clustered_parents(N_C5, dev, gen))
        idx = par.long()
        _compare_timing(f"G3 row mode] N={N_C5} [N, {w}] {kind}",
                        lambda: gather_rows(x, par),
                        lambda: gather_rows_plain(x, par), card,
                        (2 * w + 1) * 4 * N_C5,
                        lambda: torch.index_select(x[0], 0, idx))


def _profile_filter(run, y_obs, n, per_run, label, card):
    """Where a filter run's time goes: device busy time by kernel and host
    time by phase span (the om.*, c5.*, sv.* and tm.* record_function
    spans), from torch.profiler. Returns {span: times entered} of the
    profiled run."""
    from torch.profiler import profile, ProfilerActivity
    gen = torch.Generator(device="cuda").manual_seed(400)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 acc_events=True) as prof:
        run(gen, y_obs, n)
        torch.cuda.synchronize()
    ka = prof.key_averages()
    cuda = torch.autograd.DeviceType.CUDA
    counts = {e.key: e.count for e in ka
              if e.key.startswith(SPANS) and e.device_type != cuda}
    kern = [e for e in ka
            if e.device_type == cuda and not e.key.startswith(SPANS)]
    busy_ms = sum(e.self_device_time_total for e in kern) / 1e3
    if busy_ms <= 0:
        print(f"[5 profile] {label} N={n}: the profiler showed no device "
              f"time; device busy share not measured")
        return counts
    n_kern = sum(e.count for e in kern)
    top = sorted(kern, key=lambda e: -e.self_device_time_total)[:6]
    tops = "; ".join(f"{e.key[:40]} x{e.count} "
                     f"{e.self_device_time_total / 1e3:.3f} ms" for e in top)
    print(f"[5 profile] {label} N={n}: {n_kern} kernels, device busy "
          f"{busy_ms:.3f} ms of {per_run * 1e3:.3f} ms/run unprofiled (idle "
          f"share {max(0.0, 1 - busy_ms / (per_run * 1e3)):.3f}); top: "
          f"{tops}")
    phases = []
    for e in sorted((e for e in ka if e.key.startswith(SPANS)),
                    key=lambda e: (e.key, e.device_type != cuda)):
        where, ms = (("device span", e.device_time_total)
                     if e.device_type == cuda else
                     ("host", e.cpu_time_total))
        phases.append(f"{e.key} x{e.count} {where} {ms / 1e3:.2f} ms")
    print(f"[5 profile] {label} N={n} by phase (profiled run): "
          f"{'; '.join(phases)}; card {card}")
    return counts


def _sync_count(run, y_obs, n):
    """Synchronizing CUDA calls during one run, as
    torch.cuda.set_sync_debug_mode flags them: (total, the lines of the
    package that made the most)."""
    _, syncs = _synced(lambda: run(
        torch.Generator(device="cuda").manual_seed(401), y_obs, n))
    where = collections.Counter(
        w.split("genparticlefilters_tpu_torch/")[-1] for w in syncs)
    return len(syncs), where.most_common(6)


def _ess_graph_checks(card):
    """A captured check replayed 20 times bit for bit (and equal to the
    eager call), then with new weights each replay; the graph nodes inside
    one ``*.ess_check`` span (``_ess_low`` captured alone) with the kernel
    and with the chain it replaced (the parent's check); the kernel's
    counter over the replays."""
    from genparticlefilters_tpu_torch.ops import ess_check as ec
    from genparticlefilters_tpu_torch.smc import algorithms
    from genparticlefilters_tpu_torch.utils.spans import _graph_nodes
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(21)
    xs = [_ess_input("random", n, gen, dev) for n in (1_000_000, N_MAIN,
                                                      4097)]
    thrs = [0.5 * x.shape[0] for x in xs]
    for x, t in zip(xs, thrs):
        ec.ess_below(x, t, with_ess=True)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = [ec.ess_below(x, t, with_ess=True) for x, t in zip(xs, thrs)]
    ec.ess_check_runs(reset=True)

    def read():
        return [(bool(lo), e.view(torch.int32).item()) for lo, e in outs]
    graph.replay()
    first = read()
    for _ in range(19):
        graph.replay()
        if read() != first:
            raise AssertionError("ESS: a replay of the captured check "
                                 "differs from the first")
    eager = [ec.ess_below(x, t, with_ess=True) for x, t in zip(xs, thrs)]
    if [(bool(lo), e.view(torch.int32).item()) for lo, e in eager] != first:
        raise AssertionError("ESS: the replays differ from the eager call")
    runs = ec.ess_check_runs()
    if runs != 20 * 3 + 3:
        raise AssertionError(f"ESS: the counter read {runs}, not 63")
    for r in range(10):
        kind = ESS_KINDS[r % len(ESS_KINDS)]
        for x in xs:
            x.copy_(_ess_input(kind, x.shape[0], gen, dev))
        graph.replay()
        for x, t, (lo, e) in zip(xs, thrs, outs):
            lo2, e2 = ec.ess_below(x, t, with_ess=True)
            if bool(lo) != bool(lo2) or not torch.equal(
                    e.view(torch.int32), e2.view(torch.int32)):
                raise AssertionError(f"ESS: replay {r} ({kind}) differs from "
                                     f"the eager call")
    print(f"[ess graph] 20 replays of 3 captured checks (N = 1M, 100K, 4097)"
          f" bit-equal to each other and to the eager call; 10 replays on "
          f"new weights bit-equal to eager calls; the counter read {runs}")
    lw = _ess_input("random", N_MAIN, gen, dev)
    state = type("State", (), {"log_weights": lw, "n_particles": N_MAIN,
                               "mesh": None})()
    found = {}
    kernel = algorithms.ess_below
    try:
        for route, fn in (("kernel", kernel),
                          ("chain (the parent's check)", ec.ess_below_plain)):
            algorithms.ess_below = fn
            algorithms._ess_low(state, 0.5, "ess")
            torch.cuda.synchronize()
            g = torch.cuda.CUDAGraph()
            with torch.cuda.graph(g):
                a = _graph_nodes()
                low = algorithms._ess_low(state, 0.5, "ess")
                b = _graph_nodes()
            g.replay()
            found[route] = ({k: b[k] - a[k] for k in a}, bool(low))
            del g
    finally:
        algorithms.ess_below = kernel
    print(f"[ess graph] graph nodes inside one ess_check span (N={N_MAIN}, "
          f"ess_frac 0.5): " + "; ".join(f"{k}: {v[0]}, predicate {v[1]}"
                                         for k, v in found.items()))
    if found["kernel"][0]["nodes"] != 1 or found["kernel"][0]["kernels"] != 1:
        raise AssertionError(f"ESS: the check is not one node: {found}")
    if len({v[1] for v in found.values()}) != 1:
        raise AssertionError(f"ESS: the routes' predicates differ: {found}")
    return found


def _ess_timing(card, sizes=(N_MAIN, 500_000, 1_000_000)):
    """The kernel alone with L2 flushed and 20 queued, beside the chain it
    replaced (plain) and ``torch.logsumexp`` (one library call over the
    same vector), at each size; the bound is the 4N bytes read. Returns
    the numbers at N_MAIN."""
    from genparticlefilters_tpu_torch.ops.ess_check import (ess_below,
                                                            ess_below_plain)
    from smcbench.harness.devicetime import flushed_seconds
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(22)
    out = {}
    for n in sizes:
        lw = _ess_input("random", n, gen, dev)
        thr = 0.5 * n
        fns = {"kernel": lambda: ess_below(lw, thr),
               "plain": lambda: ess_below_plain(lw, thr),
               "torch.logsumexp": lambda: torch.logsumexp(lw, 0)}
        row = _compare_timing(f"ESS] N={n}", fns["kernel"], fns["plain"],
                              card, 4 * n, fns["torch.logsumexp"])
        alone = {k: 1e3 * flushed_seconds(f, dev) for k, f in fns.items()}
        bound = 4 * n / HBM_BYTES_PER_MS
        print(f"[5 ESS] N={n}: one call alone, L2 flushed (median of 30): "
              + ", ".join(f"{k} {v:.4f} ms" for k, v in alone.items())
              + f"; bound {bound:.5f} ms, share {bound / alone['kernel']:.3f}"
              f"; card {card}")
        out[n] = dict(row, flushed_ms=alone["kernel"],
                      plain_flushed_ms=alone["plain"],
                      library_flushed_ms=alone["torch.logsumexp"])
    return out[sizes[0]]


ESS_FLIP_CELLS = ("om.100k.graph.sys", "om.1m.graph.res", "sv.100k.graph",
                  "mot.1m.graph")


def _ess_flips(card, seed=2_147_483_659):
    """Every ESS check of one seed's sequence pool in each graph cell of
    the benchmark, evaluated by the kernel and by the chain it replaced
    inside the cell's captured graph: the predicates that differ (each
    with its ESS and threshold) and the largest relative ESS difference.
    The kernel's predicate drives the run."""
    from genparticlefilters_tpu_torch.ops.ess_check import ess_below_plain
    from genparticlefilters_tpu_torch.smc import algorithms
    from smcbench.harness.spec import Cell
    dev = torch.device("cuda")
    kernel = algorithms.ess_below
    total = {"checks": 0, "flips": 0}
    for name in ESS_FLIP_CELLS:
        rec = []

        def both(lw, thr):
            low, ess = kernel(lw, thr, with_ess=True)
            plow, pess = ess_below_plain(lw, thr, with_ess=True)
            if torch.cuda.is_current_stream_capturing():
                rec.append((low, plow, ess, pess, thr))
            return low
        cell = Cell(name)
        mod = cell.program()
        seqs = mod.pool(cell, seed, dev)
        gen = torch.Generator(device=dev).manual_seed(seed + 1_000_003)
        algorithms.ess_below = both
        try:
            prog = mod.Program(cell, gen, seqs)
        finally:
            algorithms.ess_below = kernel
        thr = torch.tensor([r[4] for r in rec], dtype=torch.float64)
        flips, checks, taken, worst = [], 0, 0, 0.0
        for i in range(seqs.shape[0]):
            prog.run(seqs[i])
            lo = torch.stack([r[0] for r in rec]).cpu()
            plo = torch.stack([r[1] for r in rec]).cpu()
            e = torch.stack([r[2] for r in rec]).double().cpu()
            pe = torch.stack([r[3] for r in rec]).double().cpu()
            checks += lo.numel()
            taken += int(lo.sum())
            fin = torch.isfinite(pe)
            if bool(fin.any()):
                worst = max(worst, float(((e - pe).abs() / pe)[fin].max()))
            for k in torch.nonzero(lo != plo).flatten().tolist():
                flips.append((i, k, float(e[k]), float(pe[k]),
                              float(thr[k])))
        del prog, rec
        gc.collect()
        torch.cuda.empty_cache()
        total["checks"] += checks
        total["flips"] += len(flips)
        print(f"[ess flips] {name}, seed {seed}: {seqs.shape[0]} sequences, "
              f"{checks} checks, {taken} taken by the kernel, {len(flips)} "
              f"predicate flips against the chain, largest relative ESS "
              f"difference {worst:.3g}; card {card}")
        for i, k, e, pe, t in flips:
            print(f"[ess flips] {name} sequence {i} check {k}: kernel ESS "
                  f"{e!r}, chain ESS {pe!r}, threshold {t!r}")
    return total


def phase_timing(y_obs, card):
    # configs 3 and 4 beside object motion, first: the same cells are timed
    # again after config 5 (_config34_timing)
    _config34_wall(card, "at the start of phase 5", y_obs)
    _guard_timing(card, y_obs)
    _pp_timing(card, y_obs)
    kern_ms = _kernel_timing(N_MAIN, card)
    kern_ms[GC] = _graph_cond_timing(card)
    kern_ms[CL] = _copy_leaves_timing(N_MAIN, card)
    kern_ms[ESS] = _ess_timing(card)
    _copy_leaves_timing(1_000_000, card)
    _kernel_timing(1_000_000, card)
    _skewed_timing(card)
    dev = torch.device("cuda")
    methods = ("systematic", "residual", "multinomial")
    for n in (N_MAIN, 1_000_000):
        runs = {m: [] for m in methods}
        for s in range(6):           # the methods in turns, run by run
            for method in methods:
                g2 = torch.Generator(device=dev).manual_seed(300 + s)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                _filter(method)(g2, y_obs, n)
                torch.cuda.synchronize()
                runs[method].append(time.perf_counter() - t0)
        for method in methods:
            r = runs[method][1:]             # the first run warms up
            per_run = statistics.median(r)
            print(f"[5 filter] {method} N={n} T={T_MAIN}: "
                  f"{per_run * 1e3:.3f} ms/run (median of {len(r)} after a "
                  f"warm-up, methods in turns; min {min(r) * 1e3:.3f}, max "
                  f"{max(r) * 1e3:.3f}), {n * T_MAIN / per_run:,.0f} "
                  f"particle-updates/s; card {card}")
            if method != "multinomial":
                _profile_filter(_filter(method), y_obs, n, per_run, method,
                                card)
    for method in methods:
        total, top = _sync_count(_filter(method), y_obs, N_MAIN)
        print(f"[5 syncs] {method} N={N_MAIN}: {total} synchronizing CUDA "
              f"calls in one run (torch.cuda.set_sync_debug_mode; limit "
              f"{MAX_SYNCS}); by call site: {top}")
        if total > MAX_SYNCS:
            raise AssertionError(f"{method}: {total} host syncs per run, "
                                 f"more than the {MAX_SYNCS} ESS checks")
    _config5_timing(card)
    _config34_timing(card, y_obs)
    return kern_ms


def _guard_timing(card, y_obs):
    """The batched-layout guard on the headline (systematic, N=100K): ms
    per run with the guard on (its cache warm) and off, in turns; a cold
    guarded run (cache emptied): its host time, synchronizing calls and
    profiled kernels against an unguarded run's."""
    from genparticlefilters_tpu_torch import config
    from genparticlefilters_tpu_torch.core import batching
    run = _filter("systematic")
    gen = _gen(950)
    times = {True: [], False: []}
    for _ in range(6):
        for on in (True, False):
            with config.use_check_batched_layout(on):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                run(gen, y_obs, N_MAIN)
                torch.cuda.synchronize()
                times[on].append((time.perf_counter() - t0) * 1e3)
    for on, r in times.items():
        r = r[1:]
        print(f"[5 guard] headline systematic N={N_MAIN}, guard "
              f"{'on (cache warm)' if on else 'off'}: "
              f"{statistics.median(r):.3f} ms/run (median of 5 after a "
              f"warm-up, on and off in turns; min {min(r):.3f}, max "
              f"{max(r):.3f}); card {card}")
    batching._GUARD_CACHE.clear()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run(gen, y_obs, N_MAIN)
    torch.cuda.synchronize()
    cold = (time.perf_counter() - t0) * 1e3
    batching._GUARD_CACHE.clear()
    total, top = _sync_count(run, y_obs, N_MAIN)
    if total > MAX_SYNCS:
        raise AssertionError(f"guard cold: {total} host syncs: {top}")
    kernels, alone = {}, {}
    for on in (True, False):
        with config.use_check_batched_layout(on):
            kernels[on] = _profiled_kernels(
                run, y_obs, N_MAIN, before=batching._GUARD_CACHE.clear)
            batching._GUARD_CACHE.clear()
            alone[on] = sum(_profiled_kernels(run, y_obs, N_MAIN,
                                              warm=False).values())
    if kernels[True] != kernels[False]:
        diff = {k: (kernels[True][k], kernels[False][k])
                for k in kernels[True] | kernels[False]
                if kernels[True][k] != kernels[False][k]}
        raise AssertionError(f"guard: {kernels[True].total()} kernels "
                             f"guarded, {kernels[False].total()} not; by "
                             f"name (guarded, not): {diff}")
    print(f"[5 guard] a cold guarded run (its cache emptied) {cold:.3f} "
          f"ms; {total} synchronizing calls (limit {MAX_SYNCS}); "
          f"{kernels[True].total()} kernels guarded (cold) and "
          f"{kernels[False].total()} unguarded, each kernel name the same "
          f"count (profiled after a profiler warm-up run); profiled "
          f"alone, {alone[True]} guarded and {alone[False]} unguarded; card "
          f"{card}")


def _profiled_kernels(run, y, n, before=lambda: None, warm=True):
    """Device kernels by name launched in one profiled run (seed 400).
    With ``warm`` the profiler records the second of two runs, after a
    warm-up step; ``before()`` runs ahead of each run."""
    from torch.profiler import profile, ProfilerActivity, schedule
    steps = 2 if warm else 1
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=(schedule(wait=0, warmup=1, active=1) if warm
                           else None),
                 acc_events=True) as prof:
        for _ in range(steps):
            before()
            run(torch.Generator(device="cuda").manual_seed(400), y, n)
            torch.cuda.synchronize()
            if warm:
                prof.step()
    cuda = torch.autograd.DeviceType.CUDA
    counts = collections.Counter()
    for e in prof.key_averages():
        if e.device_type == cuda and not e.key.startswith(SPANS):
            counts[e.key] += e.count
    return counts


def _pp_rows(y_obs):
    """(label, run, y, n) pairs: each per-particle cell beside its batched
    counterpart."""
    line_model, _, y_line = _line_setup()
    import copy
    pp_line = copy.copy(line_model)
    pp_line.batch_safe = False
    rows = []
    for m in ("systematic", "residual"):
        rows.append((f"4q object motion {m} N={N_MAIN}",
                     _pp_om_run(m), _filter(m), y_obs, N_MAIN))
    rows.append((f"4r line model route B N={N_LINE}", _line_run("B", pp_line),
                 _line_run("B", line_model), y_line, N_LINE))
    rows.append((f"4r SMCP3 N={N_TM} K={K_TM}", _smcp3_pp_run, _smcp3_run,
                 None, N_TM))
    rows.append((f"4s positional model N={N_MAIN}", _quad_run(False),
                 _quad_run(True), None, N_MAIN))
    rows.append((f"4v N3 N={N_NEST} T={T_NEST}",
                 _nested_run("N3", _nested_models(False)["N3"][0]),
                 _nested_run("N3", _nested_models()["N3"][0]),
                 _nested_data("N3"), N_NEST))
    return rows


def _pp_timing(card, y_obs):
    """4q, 4r, 4s and 4v per particle beside their batched counterparts, in
    turns at one point of the run: ms per run (median of 5 after a
    warm-up), profiled kernels, device busy ms and idle share, the
    boundary copies of one run and their device time; one 4q run profiled
    through utils.profiling.trace_profile."""
    import tempfile
    from genparticlefilters_tpu_torch.utils.profiling import trace_profile
    rows = _pp_rows(y_obs)
    gen = _gen(960)
    times = {(r[0], k): [] for r in rows for k in ("per particle",
                                                   "batched")}
    for _ in range(6):
        for label, pp, bb, yy, n in rows:
            for kind, run in (("per particle", pp), ("batched", bb)):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                run(gen, yy, n)
                torch.cuda.synchronize()
                times[(label, kind)].append((time.perf_counter() - t0) * 1e3)
    for label, pp, bb, yy, n in rows:
        meds = {}
        for kind, run in (("per particle", pp), ("batched", bb)):
            r = times[(label, kind)][1:]
            meds[kind] = statistics.median(r)
            maps = _boundary()
            run(gen, yy, n)
            maps = _boundary_since(maps)
            print(f"[5 per particle] {label}, {kind}: {meds[kind]:.3f} "
                  f"ms/run (median of 5 after a warm-up, the two in turns; "
                  f"min {min(r):.3f}, max {max(r):.3f}); {maps['calls']} "
                  f"maps, {maps['copies']} boundary copies "
                  f"({maps['bytes'] / 1e6:.1f} MB); card {card}")
            _profile_filter(run, yy, n, meds[kind] / 1e3, f"{label} {kind}",
                            card)
        print(f"[5 per particle] {label}: per particle / batched "
              f"{meds['per particle'] / meds['batched']:.2f}x; card {card}")
    x = torch.zeros((N_MAIN, 5 * T_MAIN), dtype=torch.int32, device="cuda")
    dev, _ = _timed({"boundary copy": lambda: x.t().contiguous()})
    nbytes = 2 * x.numel() * 4
    print(f"[5 per particle] one boundary copy of the 4q store "
          f"([{N_MAIN}, {5 * T_MAIN}] -> [{5 * T_MAIN}, {N_MAIN}] int32, "
          f"{nbytes / 1e6:.1f} MB read+written): {dev['boundary copy']:.4f} "
          f"ms device time (bound {nbytes / HBM_BYTES_PER_MS:.4f} ms; 20 "
          f"queued calls, median of 12); card {card}")
    with tempfile.TemporaryDirectory() as d:
        with trace_profile(d) as prof:
            _pp_om_run("systematic")(gen, y_obs, N_MAIN)
            torch.cuda.synchronize()
        size = os.path.getsize(os.path.join(d, "trace.json"))
    cuda = torch.autograd.DeviceType.CUDA
    kern = [e for e in prof.key_averages() if e.device_type == cuda
            and not e.key.startswith(SPANS)]
    print(f"[5 per particle] one 4q systematic run through trace_profile: "
          f"a {size / 1e6:.1f} MB Chrome trace, {sum(e.count for e in kern)}"
          f" kernels, device busy "
          f"{sum(e.self_device_time_total for e in kern) / 1e3:.3f} ms; "
          f"card {card}")


def _wall_ms(fn, reps=5):
    """Host-clock ms of ``fn()`` ending in a synchronize, after a warm-up:
    (median, min, max) of ``reps`` runs."""
    times = []
    for _ in range(reps + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    r = times[1:]
    return statistics.median(r), min(r), max(r)


def _config5_timing(card):
    """Config 5 at N=1M: the run, each resize verb, host syncs, profile."""
    import genparticlefilters_tpu_torch as g
    y = _mot_data(T_C5)
    gen = torch.Generator(device="cuda").manual_seed(700)
    med, lo, hi = _wall_ms(lambda: _c5_run(gen, y, N_C5))
    per_run = med / 1e3
    print(f"[5 config 5] MOT K=4 N={N_C5} T={T_C5} with two resizes: "
          f"{med:.3f} ms/run (median of 5 after a warm-up; min {lo:.3f}, "
          f"max {hi:.3f}), {N_C5 * T_C5 / (med / 1e3):,.0f} "
          f"particle-updates/s; card {card}")
    st = _c5_run(gen, y, N_C5)
    half = g.pf_resize(gen, st, N_C5 // 2, "residual", check=False)
    quarter = g.pf_resize(gen, st, N_C5 // 4, "optimal", check=False)
    rep = g.pf_replicate(quarter, 4)
    verbs = [
        ("pf_resize residual 1M->500K",
         lambda: g.pf_resize(gen, st, N_C5 // 2, "residual", check=False)),
        ("pf_resize multinomial 500K->1M",
         lambda: g.pf_resize(gen, half, N_C5, "multinomial", check=False)),
        ("pf_resize optimal 1M->250K",
         lambda: g.pf_resize(gen, st, N_C5 // 4, "optimal", check=False)),
        ("pf_replicate x4 250K->1M", lambda: g.pf_replicate(quarter, 4)),
        ("pf_dereplicate keepfirst 1M->250K",
         lambda: g.pf_dereplicate(gen, rep, 4)),
        ("pf_resample_blockwise systematic K=4",
         lambda: g.pf_resample_blockwise(gen, st, 4, "systematic")),
        ("pf_rotate_blocks K=4", lambda: g.pf_rotate_blocks(st, 4, 1)),
    ]
    for label, fn in verbs:
        v_med, v_lo, v_hi = _wall_ms(fn)
        print(f"[5 config 5 verb] {label}: {v_med:.3f} ms (median of 5; "
              f"min {v_lo:.3f}, max {v_hi:.3f}); card {card}")
    del st, half, quarter, rep
    run = lambda gen_, y_, n: _c5_run(gen_, y_, n)  # noqa: E731
    total, top = _sync_count(run, y, N_C5)
    print(f"[5 syncs] config 5 N={N_C5}: {total} synchronizing CUDA calls "
          f"in one run; by call site: {top}")
    _profile_filter(run, y, N_C5, per_run, "config 5", card)


def _earlier_libraries(src_dir):
    """Build ``src_dir``'s merge_count.cu and gather_parents.cu side by
    side under other library names and bind their C entry points: G4's and
    G3's column mode as today, G3's row mode without its unit table
    (``gather_rows(src, dst, cols, n_pieces, parents, n, m, stream)``)."""
    from concurrent.futures import ThreadPoolExecutor
    from genparticlefilters_tpu_torch.ops.build import (BUILD_DIR,
                                                        NVCC_FLAGS, _nvcc)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)

    def build(name):
        out = BUILD_DIR / f"libearlier_{name}.so"
        proc = subprocess.run([_nvcc()] + NVCC_FLAGS + [
            "-o", str(out), os.path.join(src_dir, f"{name}.cu")],
            capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {src_dir}/{name}.cu:\n"
                               f"{proc.stderr}")
        return ctypes.CDLL(str(out))
    with ThreadPoolExecutor(2) as pool:
        g4, g3 = pool.map(build, ("merge_count", "gather_parents"))
    vp, ll = ctypes.c_void_p, ctypes.c_longlong
    g4.merge_count.argtypes = [vp, ll, vp, ll, vp, vp]
    for fn in (g3.gather_cols, g3.gather_rows):
        fn.argtypes = [vp, vp, vp, ctypes.c_int, vp, ll, ll, vp]
    for fn in (g4.merge_count, g3.gather_cols, g3.gather_rows):
        fn.restype = ctypes.c_int
    return g4, g3


def phase_against(src_dir, card):
    """(6): the earlier G4 and G3 of ``src_dir`` against this tree's, in
    turns (earlier, this, this, earlier), each first checked bit-equal."""
    from genparticlefilters_tpu_torch.ops.fused_gather import _launch_tables
    from genparticlefilters_tpu_torch.ops.gather import (gather_cols,
                                                         gather_rows)
    from genparticlefilters_tpu_torch.ops.merge_count import merge_count
    g4, g3 = _earlier_libraries(src_dir)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(3)

    def stream():
        return torch.cuda.current_stream().cuda_stream

    def earlier_g4(c, u):
        F = torch.empty_like(c, dtype=torch.int32)
        if g4.merge_count(c.data_ptr(), c.shape[0], u.data_ptr(),
                          u.shape[0], F.data_ptr(), stream()):
            raise RuntimeError("earlier merge_count launch failed")
        return F

    def earlier_g3(fn, axis):
        def call(pieces, parents):
            m = parents.shape[0]
            outs = [torch.empty((m, p.shape[1]) if axis == 0
                                else (p.shape[0], m), dtype=torch.int32,
                                device=dev) for p in pieces]
            tables = _launch_tables(pieces, outs,
                                    [p.shape[1 - axis] for p in pieces])
            if fn(*tables, len(pieces), parents.data_ptr(),
                  pieces[0].shape[axis], m, stream()):
                raise RuntimeError("earlier G3 launch failed")
            return outs
        return call
    earlier_rows = earlier_g3(g3.gather_rows, 0)
    earlier_cols = earlier_g3(g3.gather_cols, 1)

    def ab(label, earlier, this, nbytes):
        a, b = earlier(), this()
        same = (torch.equal(a, b) if isinstance(a, torch.Tensor)
                else all(torch.equal(x, y) for x, y in zip(a, b)))
        if not same:
            raise AssertionError(f"6 {label}: earlier and this differ")
        dev_ms, call_ms = _timed({"earlier": earlier, "this": this})
        bound = nbytes / HBM_BYTES_PER_MS
        print(f"[6 {label}] device time per call (20 queued calls, median "
              f"of 12): earlier {dev_ms['earlier']:.4f} ms (share "
              f"{bound / dev_ms['earlier']:.3f}), this {dev_ms['this']:.4f} "
              f"ms (share {bound / dev_ms['this']:.3f}), bound {bound:.5f} "
              f"ms; one call with the host in the loop: earlier "
              f"{call_ms['earlier']:.4f} ms, this {call_ms['this']:.4f} ms; "
              f"bit-equal; card {card}")
    for n, m, kind in [(N_MAIN, N_MAIN, "plain"),
                       (1_000_000, 1_000_000, "plain"), *G4_SKEWED]:
        c, u = _g4_inputs(n, m, kind, dev, gen)
        ab(f"G4 n={n} m={m} {kind}", lambda: earlier_g4(c, u),
           lambda: merge_count(c, u), 8 * n + 4 * m)
    for n, w, kind in [(N_MAIN, 8, "permutation"), (N_MAIN, 8, "clustered")] \
            + [(N_C5, w, kind) for w, kind in G3R_TIMED]:
        x = _row_pieces((w,), n, dev, gen)
        par = (torch.randperm(n, generator=gen, device=dev).to(torch.int32)
               if kind == "permutation" else _clustered_parents(n, dev, gen))
        ab(f"G3 row mode N={n} [N, {w}] {kind}", lambda: earlier_rows(x, par),
           lambda: gather_rows(x, par), (2 * w + 1) * 4 * n)
    for n in (N_MAIN, N_C5):
        pieces = _pieces(WIDTHS_C5, n, dev, gen)
        par = _clustered_parents(n, dev, gen)
        ab(f"G3 column mode N={n} widths={WIDTHS_C5} clustered",
           lambda: earlier_cols(pieces, par), lambda: gather_cols(pieces, par),
           (2 * sum(WIDTHS_C5) + 1) * 4 * n)


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--against", metavar="DIR",
                        help="time DIR's merge_count.cu and gather_parents.cu"
                             " against this tree's (phase 6)")
    parser.add_argument("--config34-only", action="store_true",
                        help="build, then only time configs 3 and 4 beside "
                             "object motion in this fresh process; prints "
                             "no result line")
    parser.add_argument("--repro-only", action="store_true",
                        help="build, run routes 4o B and 4c multinomial once "
                             "from their seeds and print their LML bits as "
                             "JSON (the fresh process of the repro check); "
                             "no result line")
    args = parser.parse_args()
    # an op without a batching rule would run vmap's per-element loop
    torch._C._functorch._set_vmap_fallback_warning_enabled(True)
    warnings.filterwarnings("error", message=".*performance drop.*")
    if args.repro_only:
        if not torch.cuda.is_available():
            raise RuntimeError("--repro-only needs a CUDA card")
        from genparticlefilters_tpu_torch.ops.build import load_all
        load_all()
        print(json.dumps(_repro_runs()))
        return
    phase_environment()
    card = _card_line()
    phase_build()
    if args.config34_only:
        _config34_wall(card, "in a fresh process", _data())
        torch.distributed.destroy_process_group()
        return
    max_err = phase_kernel_vs_plain()
    _ess_graph_checks(card)
    y_obs = _data()
    main_counts, main_state = phase_main_path(y_obs)
    seen = phase_paths(y_obs, main_state)
    del main_state
    kern_ms = phase_timing(y_obs, card)
    if args.against:
        phase_against(args.against, card)
    # last: a capture registers the default generator with its graph and
    # the profiler then traces graph replays, so 4x runs after every count
    # of the eager paths
    x_seen = _captured_paths(y_obs)
    _ess_flips(card)
    launches = {G1: main_counts[G1],
                G2: seen["4a"][G2],
                G3: seen["4f"][G3],
                G3R: seen["4j"][G3R],
                G4: seen["4d"][G4],
                G5: seen["4a"][G5],
                GC: x_seen[f"4x headline systematic N={N_MAIN} "
                           f"T={T_MAIN}"][GC],
                CL: x_seen[f"4x headline systematic N={N_MAIN} "
                           f"T={T_MAIN}"][CL],
                ESS: main_counts[ESS]}
    if torch.distributed.is_initialized():
        torch.distributed.destroy_process_group()
    print(json.dumps({"kernels": [{
        "name": name, "route": "cuda", "source": src, "replaces": rep,
        "launches": launches[name], "max_abs_err": max_err[name],
        **kern_ms[name], "bound_by": "bytes"}
        for name, (src, rep) in KERNELS.items()]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()

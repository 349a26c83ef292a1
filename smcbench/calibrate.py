"""Readings that the check's limits are set from, at a cell's own size.

    python3 smcbench/calibrate.py --workload <cell> --seeds <n> \\
        --first-seed <s> --seconds <s> [--control-seeds <n>] \\
        [--control-dtype bfloat16|float32] [--fault <name> --fault-seeds <n>] \\
        [--witness <seed>[,<seed>...] --witness-repeats <r>]

- for each of ``--seeds`` seeds, one untraced run of the program (a short
  window at the cell's load, its sampled runs judged);
- for each of ``--control-seeds`` seeds, the reference filter in
  ``--control-dtype`` put in the program's place;
- for each of ``--fault-seeds`` seeds, the program with ``--fault``
  planted (:mod:`smcbench.harness.faults`);
- for each seed of ``--witness``, every sequence of the seed's pool
  filtered ``--witness-repeats`` times by the program and as often by
  the reference filter in float32, each answer judged: the second
  witness of the program's statistical gaps.

One JSON line per run on standard output (``kind``, ``seed``,
``correct``, ``checks``, ``metrics``; a witness line per seed), and at
the end the largest reading of each number over the program's runs and
the smallest over the control's and the fault's. All in one process, on
the card.
"""

import argparse
import contextlib
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

#: the witness's statistical numbers
STATISTICAL = ("lml_gap", "posterior_gap")


def witness(cell, seed: int, repeats: int, device="cuda") -> dict:
    """Every sequence of ``seed``'s pool, filtered ``repeats`` times by the
    program and by the float32 reference filter, judged: per side, the
    statistical numbers of each answer and its LML's signed error
    (``lml_error``), in pool order, ``repeats`` answers per sequence."""
    import torch
    from smcbench.reference.control import Control
    mod, ref = cell.program(), cell.reference()
    seqs = mod.pool(cell, seed, torch.device(device))
    gen = torch.Generator(device=device).manual_seed(seed + 1_000_003)
    sides = {"program": mod.Program(cell, gen, seqs),
             "reference": Control(cell, gen, seqs, torch.float32)}
    exact = [ref.exact_lml(s, cell.config) for s in seqs]
    out = {}
    for side, prog in sides.items():
        got = {n: [] for n in STATISTICAL + ("lml_error",)}
        for j in range(len(seqs)):
            for _ in range(repeats):
                ans = prog.answer(prog.run(seqs[j]))
                r = ref.judge(ans, seqs[j], cell.config,
                              cell.traffic["ess_frac"])
                for n in STATISTICAL:
                    got[n].append(float(r[n]))
                got["lml_error"].append(float(ans["lml"]) - exact[j])
                del ans
        out[side] = got
        del prog
        sides[side] = None
        torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--first-seed", type=int, default=3_000_000_000)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--control-dtype", default="bfloat16")
    ap.add_argument("--fault", default=None)
    ap.add_argument("--fault-seeds", type=int, default=3)
    ap.add_argument("--witness", default="")
    ap.add_argument("--witness-repeats", type=int, default=2)
    args = ap.parse_args(argv)
    import torch
    from smcbench.harness.spec import Cell
    from smcbench.harness.runner import execute
    from smcbench.harness.faults import planted
    from smcbench.reference.control import Control
    if not torch.cuda.is_available():
        print("calibrate: no CUDA card", file=sys.stderr)
        return 2
    cell = Cell(args.workload)
    dtype = getattr(torch, args.control_dtype)
    readings = {"program": {}, "control": {}, "fault": {}}
    plan = ([("program", None)] * args.seeds
            + [("control", lambda c, g, s: Control(c, g, s, dtype))]
            * args.control_seeds
            + ([("fault", None)] * args.fault_seeds if args.fault else []))
    for i, (kind, program) in enumerate(plan):
        seed = args.first_seed + 7919 * i
        fault = (planted(cell, args.fault) if kind == "fault"
                 else contextlib.nullcontext())
        with fault:
            r = execute(cell, seed, args.seconds, False, "cuda",
                        time.perf_counter(), program=program)
        print(json.dumps({"kind": kind, "seed": seed,
                          "correct": r["correct"], "attempted": r["attempted"],
                          "checks": {k: v["value"]
                                     for k, v in r["checks"].items()},
                          "metrics": {k: v["value"]
                                      for k, v in r["metrics"].items()}}),
              flush=True)
        for k, v in r["checks"].items():
            readings[kind].setdefault(k, []).append(v["value"])
    for seed in [int(x) for x in args.witness.split(",") if x]:
        w = witness(cell, seed, args.witness_repeats)
        print(json.dumps({"kind": "witness", "seed": seed,
                          "repeats": args.witness_repeats, **w}), flush=True)
    print(json.dumps({
        "workload": cell.name,
        "program_max": {k: max(v) for k, v in readings["program"].items()},
        "control_min": {k: min(v) for k, v in readings["control"].items()},
        "fault_min": {k: min(v) for k, v in readings["fault"].items()},
        "control_dtype": args.control_dtype, "fault": args.fault}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

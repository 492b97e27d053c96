"""The readings that a cell's limits are set from (not run by the
benchmark's own runs):

    python3 portbench/calibrate.py --workload <cell> --seeds 1,2,... \
        [--control-seeds 1,2,3] [--seconds 2]

For each seed it drives the cell's set-up (and, for a serving cell, a
short window of ``--seconds`` at the cell's own load) and prints the
numbers that the comparison with the reference reads, with no limit:

    program   the program as the configuration states it (sound runs)
    control   the program with TF32 on for cuBLAS and cuDNN, the nearest
              precision below the configuration's float32
    half      (training) the reference in the program's place, each step
              on the first half of its batch, the mean over those rows

A state left unchanged reads 1 on ``change_gap`` by its definition and
needs no run. A summary line gives, per number, the largest reading of
the sound runs and the smallest of the control's and of each fault's.
"""

import argparse
import json
import math
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NO_LIMIT = math.inf


def readings(name, seed, seconds, control=None, with_half=False):
    """{mode: {number: value}} of one seed."""
    import torch

    from portbench import compare, harness

    bench, cell, config, params, limits = harness.cell_files(name, ROOT)
    open_limits = {k: NO_LIMIT for k in limits}
    run = harness.Run(name, config, params, open_limits, seed, seconds,
                      False, torch.device("cuda", 0), control=control)
    harness.set_math_mode(torch, config["precision"], control)
    kind = harness.load_module(os.path.join(harness.PB, "traffic",
                                            params["kind"] + ".py"),
                               "portbench_kind_")
    job = kind.Job(run)
    job.setup()
    out = {}
    if params["kind"] == "train_job":
        prog = job.program_readings()
        job.release()
        ref = job.reference_readings()
        mode = "control" if control else "program"
        out[mode] = {n: v for n, v, _ in compare.train(prog, ref,
                                                        open_limits)}
        print(json.dumps({"seed": seed, "mode": mode,
                          "leaves": leaf_readings(prog, ref)}),
              file=sys.stderr, flush=True)
        if with_half:
            half = job.reference_readings(half_batch=True)
            out["half"] = {n: v for n, v, _ in
                           compare.train(half, ref, open_limits)}
            print(json.dumps({"seed": seed, "mode": "half",
                              "leaves": leaf_readings(half, ref)}),
                  file=sys.stderr, flush=True)
    else:
        job.window(seconds)
        job.release()
        out["control" if control else "program"] = {
            n: v for n, v, _ in job.check()}
    harness.set_math_mode(torch, config["precision"])
    del job
    torch.cuda.empty_cache()
    return out


def leaf_readings(prog, ref):
    """Every leaf's gap behind the leaf-by-leaf numbers of a training
    cell: where a number reads high, the look starts there."""
    from portbench import compare

    moved = compare.moved(ref["grad_norms"][0])
    return {"grad": compare.leaf_gaps(prog["grad_norms"][0],
                                      ref["grad_norms"][0]),
            "replay_grad": compare.leaf_gaps(prog["grad_norms"][1],
                                             ref["grad_norms"][1]),
            "change": compare.leaf_gaps(prog["change_norms"],
                                        ref["change_norms"], moved)}


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control-seeds", default="")
    p.add_argument("--seconds", type=float, default=2.0)
    args = p.parse_args(argv)
    sys.path.insert(0, ROOT)
    seeds = [int(s) for s in args.seeds.split(",") if s]
    control_seeds = [int(s) for s in args.control_seeds.split(",") if s]
    table = {}
    for seed in seeds:
        t0 = time.time()
        got = readings(args.workload, seed, args.seconds,
                       with_half=seed in control_seeds)
        if seed in control_seeds:
            got.update(readings(args.workload, seed, args.seconds,
                                control="tf32"))
        for mode, nums in got.items():
            print(json.dumps({"seed": seed, "mode": mode, **nums,
                              "seconds": time.time() - t0}), flush=True)
            for n, v in nums.items():
                table.setdefault(mode, {}).setdefault(n, []).append(v)
    summary = {mode: {n: (max(v) if mode == "program" else min(v))
                      for n, v in nums.items()}
               for mode, nums in table.items()}
    print(json.dumps({"workload": args.workload, "summary": summary}),
          flush=True)


if __name__ == "__main__":
    main()

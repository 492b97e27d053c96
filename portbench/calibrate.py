"""The readings that a cell's limits are set from (not run by the
benchmark's own runs):

    python3 portbench/calibrate.py --workload <cell> --seeds 1,2,... \
        [--control-seeds 1,2,3] [--seconds 2]

Each run, sound or control, has a process of its own, as the driver's
runs do: cuDNN chooses its algorithms once a process and a shape, so a
sweep in one process would see one choice. A run drives the cell's
set-up (and, for a serving cell, a short window of ``--seconds`` at the
cell's own load); one JSON line a mode gives the numbers that the
comparison with the reference reads, with no limit:

    program   the program as the configuration states it (sound runs)
    control   the program with TF32 on for cuBLAS and cuDNN, the nearest
              precision below the configuration's float32
    half      (training) the reference in the program's place, each step
              and each eval on the first half of its batch

and, for a training cell, on standard error every leaf's gap behind the
leaf-by-leaf numbers, by step. A state left unchanged reads 1 on
``grad_gap``, ``change_gap`` and ``state_gap`` by their definitions and
needs no run.
The last line gives, per mode and number, the largest reading of the
sound runs and the least of the control's and the fault's, and how many
seeds fail each number at the cell's current limits.
"""

import argparse
import json
import math
import multiprocessing
import os
import sys
import time
from concurrent.futures import ProcessPoolExecutor

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NO_LIMIT = math.inf


def readings(name, seed, seconds, control=None, with_half=False):
    """{mode: {number: value}} of one seed, in this process."""
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
    mode = "control" if control else "program"
    if params["kind"] == "train_job":
        job.release()
        records = [(mode, job.program)]
        if with_half:
            records.append(("half", job.half_batch_record()))
        for mode, record in records:
            prog, ref = job.readings(record), job.follow(record)
            out[mode] = {n: v for n, v, _ in compare.train(prog, ref,
                                                            open_limits)}
            print(json.dumps({"seed": seed, "mode": mode,
                              "leaves": leaf_readings(prog, ref)}),
                  file=sys.stderr, flush=True)
    else:
        job.window(seconds)
        job.release()
        out[mode] = {n: v for n, v, _ in job.check()}
    harness.set_math_mode(torch, config["precision"])
    del job
    torch.cuda.empty_cache()
    return out


def leaf_readings(prog, ref):
    """Every leaf's gap behind the leaf-by-leaf numbers of a training
    cell, a dict a checked step (the state's by part): where a number
    reads high, the look starts there."""
    from portbench import compare

    return {"grads": [compare.leaf_gaps(p, r)
                      for p, r in zip(prog["grads"], ref["grads"])],
            "changes": [compare.leaf_gaps(p, r, compare.moved(g))
                        for p, r, g in zip(prog["changes"], ref["changes"],
                                           ref["grads"])],
            "states": [{k: compare.miss_gaps(miss[k], move[k]) for k in move}
                       for miss, move in zip(ref["misses"], ref["moves"])]}


def fresh(*args):
    """``readings(*args)`` in a process of its own, spawned, so that it
    makes cuDNN's choices anew."""
    spawn = multiprocessing.get_context("spawn")
    with ProcessPoolExecutor(1, mp_context=spawn) as pool:
        return pool.submit(readings, *args).result()


def summary(workload, lines, limits):
    """Per mode and number: the sound runs' largest reading, the least of
    the control's and the fault's, and the seeds over the limit; and the
    runs that crashed."""
    table, crashed = {}, []
    for line in lines:
        if "crashed" in line:
            crashed.append((line["seed"], line["mode"]))
            continue
        for n, v in line["numbers"].items():
            table.setdefault(line["mode"], {}).setdefault(n, []).append(
                (v, line["seed"]))
    out = {}
    for mode, nums in table.items():
        pick = max if mode == "program" else min
        out[mode] = {n: {"reading": pick(vs)[0], "seed": pick(vs)[1],
                         "runs": len(vs), "limit": limits.get(n),
                         "over": sorted(s for v, s in vs
                                        if not v <= limits.get(n, NO_LIMIT))}
                     for n, vs in nums.items()}
    return {"workload": workload, "summary": out, "crashed": crashed}


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="",
                   help="one sound run each; a seed given twice runs twice")
    p.add_argument("--control-seeds", default="",
                   help="one control run each; the first sound run of each "
                        "also makes the half-batch fault's record")
    p.add_argument("--seconds", type=float, default=2.0)
    args = p.parse_args(argv)
    sys.path.insert(0, ROOT)
    from portbench import harness

    limits = harness.cell_files(args.workload, ROOT)[4]
    seeds = [int(s) for s in args.seeds.split(",") if s]
    control_seeds = [int(s) for s in args.control_seeds.split(",") if s]
    halves, lines = set(control_seeds), []
    for seed, control in [(s, None) for s in seeds] \
            + [(s, "tf32") for s in control_seeds]:
        half = control is None and seed in halves
        halves.discard(seed)
        t0 = time.time()
        try:
            got = fresh(args.workload, seed, args.seconds, control, half)
        except Exception as exc:    # a crash gives no number
            got = {"control" if control else "program": repr(exc)}
        for mode, nums in got.items():
            line = {"seed": seed, "mode": mode, "seconds": time.time() - t0}
            line.update({"crashed": nums} if isinstance(nums, str)
                        else {"numbers": nums})
            print(json.dumps(line), flush=True)
            lines.append(line)
    print(json.dumps(summary(args.workload, lines, limits)), flush=True)


if __name__ == "__main__":
    main()

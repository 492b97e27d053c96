"""The knee of the online serving cell (not run by the benchmark's own
runs): the highest rate whose backlog does not grow over a window.

    python3 portbench/sweep.py --workload mnist40.serve.online \
        --rates 500,1000,1500 [--seconds 5] [--seed 1]

Sets the cell up once, then offers its traffic at each rate for
``--seconds`` and prints, per rate, the latency median and 95th percentile,
the server's busy share (service time over the window), and the backlog:
how late the requests of the window's first and last tenth started. A
backlog that grows, the last tenth's lateness well above the first's and
above a few service times, marks a rate above the knee.
"""

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--workload", default="mnist40.serve.online")
    p.add_argument("--rates", required=True)
    p.add_argument("--seconds", type=float, default=5.0)
    p.add_argument("--seed", type=int, default=1)
    args = p.parse_args(argv)
    sys.path.insert(0, ROOT)
    import numpy as np
    import torch

    from portbench import harness

    _, _, config, params, limits = harness.cell_files(args.workload, ROOT)
    run = harness.Run(args.workload, config, params, limits, args.seed,
                      args.seconds, False, torch.device("cuda", 0))
    harness.set_math_mode(torch, config["precision"])
    kind = harness.load_module(os.path.join(harness.PB, "traffic",
                                            params["kind"] + ".py"),
                               "portbench_kind_")
    job = kind.Job(run)
    job.setup()
    job.sampling = False
    for rate in [float(r) for r in args.rates.split(",")]:
        job.rate = rate
        arrivals, sizes, offs = job.offered(args.seconds)
        t0, times = job.serve(arrivals, sizes, offs)
        due, start, end = (np.asarray(x) for x in zip(*times))
        late = start - due
        tenth = max(1, len(late) // 10)
        print(json.dumps({
            "rate_per_s": rate, "requests": len(times),
            "p50_ms": 1e3 * float(np.percentile(end - due, 50)),
            "p95_ms": 1e3 * float(np.percentile(end - due, 95)),
            "busy_share": float((end - start).sum() / (end[-1] - t0)),
            "late_first_tenth_ms": 1e3 * float(late[:tenth].mean()),
            "late_last_tenth_ms": 1e3 * float(late[-tenth:].mean()),
            "service_mean_ms": 1e3 * float((end - start).mean()),
        }), flush=True)
    job.release()


if __name__ == "__main__":
    main()

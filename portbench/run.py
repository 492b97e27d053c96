"""The benchmark of scae_tpu_torch on one NVIDIA H100.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

runs one cell of BENCHMARK.json and prints, as the last line of standard
output, one JSON object: correct, attempted, failed, metrics, device (and
breakdown in a traced run), and last the numbers its comparison with the
plain reference compared, each with its limit (also the last lines of
standard error). Without a CUDA card it prints no result and exits with 2.
"""

import argparse
import os
import sys
import time

T_START = time.time()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# every cache of the program and of the libraries it may compile with
# lies at a fixed path inside the checkout
for var, sub in (("TRITON_CACHE_DIR", "triton"),
                 ("TORCHINDUCTOR_CACHE_DIR", "inductor"),
                 ("CUDA_CACHE_PATH", "cuda")):
    os.environ[var] = os.path.join(ROOT, "portbench", ".cache", sub)
# one host thread for the libraries' own CPU work: the harness's loop and
# the program's host path are what the host runs
os.environ["OMP_NUM_THREADS"] = "1"


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


if __name__ == "__main__":
    args = parse()
    sys.path.insert(0, ROOT)
    from portbench import harness

    sys.exit(harness.main(args, T_START))

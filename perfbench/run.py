"""One run of one benchmark cell of the PyTorch port on the GPU(s) of this machine.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Prints one JSON line last on stdout (`correct`, `attempted`, `failed`,
`metrics`, `device`, with `--trace 1` `breakdown`, and `checks`: each number
compared with its limit, which stderr's last lines repeat). With `--trace 0`
the metrics are the cell's end-to-end metrics, with `--trace 1` its per-layer
ones. Exits nonzero with no result where CUDA is missing or has fewer devices
than the cell asks for, or where JAX or the JAX package was loaded. The cells,
configurations, traffic and metrics are the files BENCHMARK.json names
(perfbench/harness/cell.py).
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    # the program's build and kernel caches stay inside the checkout
    os.environ["TRITON_CACHE_DIR"] = os.path.join(ROOT, "build", "perfbench", "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(ROOT, "build", "perfbench", "extensions")
    os.environ["USE_FLAX"] = "0"
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    from perfbench.harness import cell

    return cell.run(args, T_START)


if __name__ == "__main__":
    sys.exit(main())

"""Run one cell of the port's benchmark once on the CUDA card.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

The cell, its configuration (`portbench/configs/<config>.json`) and its
traffic mix (`portbench/traffic/<mix>.json`) come from BENCHMARK.json at
the root of the checkout. The run builds the scene, warms up the cell's
shapes (set-up), measures for `--seconds`, with `--trace 1` profiles a
slice, compares the window's answers with the plain reference
(`portbench/pbref`), and prints one JSON line last on standard output.
It exits non-zero, printing no result, without a CUDA card (or with fewer
than the cell asks for) and when a JAX module was loaded.
"""
import time

T0 = time.perf_counter()  # set-up counts from the process's start

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    if args.seed < 0:
        ap.error("--seed is a whole number >= 0")

    with open(ROOT / "BENCHMARK.json") as f:
        bench = json.load(f)
    cell = next((w for w in bench["workloads"]
                 if w["name"] == args.workload), None)
    if cell is None:
        print(f"no workload {args.workload!r}", file=sys.stderr)
        return 2

    # every build and kernel cache of the run stays in the checkout
    build = ROOT / "build"
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton_cache")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")

    import torch

    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell["chips"]:
        print(f"{args.workload} needs {cell['chips']} CUDA device(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 3
    sys.path[:0] = [str(ROOT), str(HERE)]
    from pbh import common, runner

    torch.set_num_threads(min(4, torch.get_num_threads()))
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    result, numbers = runner.run_cell(
        torch, bench, ROOT, args.workload, args.seed, args.seconds,
        bool(args.trace), device, T0)
    bad = common.forbidden_modules()
    if bad:
        print(f"forbidden modules loaded: {bad}", file=sys.stderr)
        return 4
    common.emit(result, numbers)
    return 0


if __name__ == "__main__":
    sys.exit(main())

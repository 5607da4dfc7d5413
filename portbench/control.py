"""The readings that the limits of `correct` are set from, for one cell:
the program against the reference on many seeds (the lower reading),
and the precision control, the reference computed in bfloat16 in the
program's place, against the float32 reference on the same answers
(the upper reading). Not part of a benchmark run.

    python3 portbench/control.py --workload <cell> --seeds 101 102 ... \
        [--control-seeds 101 102 103] [--out readings.json]

Each seed runs the cell's set-up once (a render cell's and a training
cell's are kept from seed to seed, their seed-drawn parts drawn anew)
and then, at the cell's own size and load, as many requests as one
answer to compare needs (a render; a run of preview passes across an
edit; two train steps after the set-up's), compares them as a benchmark
run does, and prints one line per seed.
"""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def readings(torch, bench, name, seeds, control_seeds, device, resize=None,
             log=print, fault_seeds=()):
    """{"program": [(seed, {number: value})], "control": [...], "faults":
    [(seed, fault, {number: value})]}: faults are read for a training
    cell only, on `fault_seeds`, each against the float32 reference of
    the steps the faulty program took."""
    from pbh import cells, checks, faults, runner

    cell, _, config, traffic = runner.resolve(bench, ROOT, name)
    if resize:
        config = {**config, **resize.get("config", {})}
        traffic = {**traffic, **resize.get("traffic", {})}
    kind_cls = cells.load(traffic["kind"])
    out = {"program": [], "control": [], "faults": []}
    kind = None
    for seed in seeds:
        log(f"{name} seed {seed} at {time.perf_counter() - T0:.1f} s")
        if kind is None or not hasattr(kind, "reseed"):
            kind = kind_cls(torch, cell, config, traffic, seed, device)
            kind.setup()
        else:
            kind.reseed(seed)
        if hasattr(kind, "control"):  # a training cell
            window(kind)
            got = kind.compare(keep_program=True)
            out["program"].append((seed, got))
            log(f"{name} seed {seed} program: {got!r}")
            if seed in control_seeds:
                low = kind.control()
                out["control"].append((seed, low))
                log(f"{name} seed {seed} control (bfloat16 reference): "
                    f"{low!r}")
            for fault in ("half_batch", "answer_altered"):
                if seed not in fault_seeds:
                    break
                patches = faults.Patches()
                try:
                    faults.FAULTS[fault](kind, patches)
                    kind.reseed(seed)
                    window(kind)
                finally:
                    patches.undo()
                bad = kind.compare(keep_program=True)
                out["faults"].append((seed, fault, bad))
                log(f"{name} seed {seed} fault {fault}: {bad!r}")
            continue
        window(kind)
        got, want = kind.check()
        l1, bias = checks.image_numbers(got, want)
        out["program"].append((seed, {"pixel_l1": l1, "mean_bias": bias}))
        log(f"{name} seed {seed} program: pixel_l1 {l1!r} mean_bias {bias!r}")
        if seed in control_seeds:
            _, low = kind.check(dtype=torch.bfloat16)
            l1, bias = checks.image_numbers(low, want)
            out["control"].append((seed, {"pixel_l1": l1, "mean_bias": bias}))
            log(f"{name} seed {seed} control (bfloat16 reference): "
                f"pixel_l1 {l1!r} mean_bias {bias!r}")
    return out


def window(kind):
    """A short window at the cell's own load: as many requests as one
    answer to compare needs."""
    kind.begin_window()
    for _ in range(kind.requests_per_answer()):
        kind.request()
        kind.attempted += 1
    kind.window["seconds"] = 0.0
    kind.finish_window()


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, nargs="*", default=None)
    ap.add_argument("--fault-seeds", type=int, nargs="*", default=())
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 3
    sys.path[:0] = [str(ROOT), str(HERE)]
    with open(ROOT / "BENCHMARK.json") as f:
        bench = json.load(f)
    control = set(args.seeds[:3] if args.control_seeds is None
                  else args.control_seeds)
    res = readings(torch, bench, args.workload, args.seeds, control,
                   torch.device("cuda", 0),
                   log=lambda s: print(s, flush=True),
                   fault_seeds=set(args.fault_seeds))
    res["card"] = torch.cuda.get_device_name(0)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(res, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())

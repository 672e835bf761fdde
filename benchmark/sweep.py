"""Readings over seeds for setting a cell's limits: the program's and the
lower-precision control's.

    python3 -m benchmark.sweep --workload <cell> --seconds <s>
        --seeds <n> [<n> ...] [--control] [--out FILE]

Each seed is one run of the cell (`run.execute`) in this process, its
window as long as `--seconds`; the control is the reference computed one
precision lower at each stage, on the stage's own inputs from that run
(`run.lower`: fp8 below bf16, bf16 below fp32; the solves' rows in bf16
with float32 sums). One JSON line a seed goes to standard output and, with
`--out`, to that file. The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

from benchmark import run


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m benchmark.sweep")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    cell = run.load_cell(args.workload)
    if not run.torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 3
    for seed in args.seeds:
        out = run.execute(cell, seed, args.seconds, False,
                          control=args.control,
                          started=time.perf_counter())
        line = {"workload": args.workload, "seed": seed,
                "correct": out["result"]["correct"],
                "metrics": {k: v["value"] for k, v in
                            out["result"]["metrics"].items()},
                "memory_peak_bytes":
                    out["result"]["device"]["memory_peak_bytes"],
                "info": out["info"], "program": out["values"],
                "loop": out["loop"]}
        if "control" in out:
            line["control"] = out["control"]
        text = json.dumps(line)
        print(text, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(text + "\n")
    bad = run.forbidden_modules()
    if bad:
        print(f"loaded {bad}", file=sys.stderr)
        return 4
    return 0


if __name__ == "__main__":
    sys.exit(main())

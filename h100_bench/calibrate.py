"""Readings that set a cell's limits, many runs in one process (one set-up
of the interpreter and of the kernels' build).

    python3 h100_bench/calibrate.py --workload <cell> --seeds 1,2,3 --seconds 50 \\
        [--control 1] [--witness 24] [--trace-seeds 2,3]

For each seed it runs the cell as ``run.py`` does (traced for the seeds in
``--trace-seeds``) and prints one JSON line: the seed, the end-to-end or
per-layer metrics, the checks, the seconds the reference took, and the
program's gaps on the compared requests with the share that are not the
reference's best. ``--control 1`` adds the gaps of the fp8 control on the
same requests; ``--witness N`` the largest difference, over the first N
of those requests, between the program's gaps against the TF32 reference
and against the reference with TF32 off. The benchmark's runs never run it.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE.parent))

from h100_bench import run  # noqa: E402


def detail(g: list[float]) -> dict:
    """The gap numbers, the share of tokens that are not the reference's
    best, and every gap."""
    return {**run.gap_numbers(g), "not_best": sum(1 for x in g if x > 0) / len(g),
            "n": len(g), "gaps": [round(x, 5) for x in g]}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--control", type=int, default=0)
    ap.add_argument("--witness", type=int, default=0)
    ap.add_argument("--trace-seeds", default="")
    args = ap.parse_args()

    import torch

    from h100_bench.spec import Spec

    if not torch.cuda.is_available():
        print("calibrate.py needs a CUDA device", file=sys.stderr)
        return 2
    spec = Spec()
    traced = {int(s) for s in args.trace_seeds.split(",") if s}
    for seed in [int(s) for s in args.seeds.split(",")]:
        state = run.serve(spec, args.workload, seed, args.seconds, seed in traced)
        t0 = time.monotonic()
        res = run.result(state)
        line = {"seed": seed, "trace": seed in traced, "correct": res["correct"],
                "attempted": res["attempted"], "failed": res["failed"],
                "metrics": {k: v["value"] for k, v in res["metrics"].items()},
                "checks": {k: v["value"] for k, v in res["checks"].items()},
                "reference_s": time.monotonic() - t0,
                "memory_peak_bytes": res["device"]["memory_peak_bytes"]}
        if "breakdown" in res:
            line["device"] = res["device"]
            line["breakdown"] = res["breakdown"]
        if state.gaps:
            line["program"] = detail(state.gaps)
        args_ref = (state.params, state.arch, state.win)
        if args.control and state.sample:
            line["fp8"] = detail(run.gaps(*args_ref, state.sample, state.device, quant="fp8"))
        if args.witness and state.sample:
            rids = state.sample[:args.witness]
            f32 = run.gaps(*args_ref, rids, state.device, tf32=False)
            line["f32_witness"] = {
                "n": len(f32), "max_abs_diff": max(abs(a - b) for a, b in zip(f32, state.gaps)),
                **run.gap_numbers(f32)}
        print(json.dumps(line), flush=True)
        del state, args_ref
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Read the compared numbers of the program and of the control on the card,
over several seeds in one process: the readings a cell's limits are set
from.

    python3 meterbench/control.py --workload loudness.served --seeds 11 12 13 --seconds 40

For each seed: one run of the cell (as ``run.py`` makes it, without its
metrics), the program's numbers against the reference, and the control's:
the reference computed at TF32 in the program's place, over the same
streams and hops.  Prints a JSON line a seed, then the largest program
reading and the smallest control reading of each number.  The benchmark's
own runs do not run the control.
"""

from __future__ import annotations

import time

STARTED = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    from meterbench import check, manifest, served

    cell = manifest.cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"control: {args.workload} needs {cell.chips} CUDA device(s)", file=sys.stderr)
        return 3
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    program, control = {}, {}
    for seed in args.seeds:
        run_ = served.run(cell, seed, args.seconds, False, "cuda:0", time.perf_counter())

        def samples(k, n, run_=run_):
            return served.samples(run_, k, n)

        p = check.numbers(cell, run_, samples)
        c = check.numbers(cell, run_, samples, "tf32")
        for k, v in p.items():
            program[k] = max(program.get(k, 0.0), v)
            control[k] = min(control.get(k, float("inf")), c[k])
        print(json.dumps({"seed": seed, "hops": run_.hops, "fetches": run_.fetches,
                          "streams_realtime": served.end_to_end(run_)["streams_realtime"],
                          "program": p, "control": c}), flush=True)
    print(json.dumps({"largest_program": program, "smallest_control": control,
                      "seconds": time.perf_counter() - STARTED}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

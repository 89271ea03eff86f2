"""Run one cell of the port's benchmark once.

    python3 meterbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout.  Loads and warms up (``setup_s``), measures
for ``--seconds``, checks the sampled streams against the plain reference,
and prints the compared numbers with their limits as the last lines of
standard error and one JSON object as the last line of standard output.
With ``--trace 0`` the object's metrics are the cell's end-to-end metrics;
with ``--trace 1`` its per-layer metrics, read from the window's host spans
and a profiled stretch of it.  Needs as many CUDA devices as the cell asks
for; there is no CPU fallback.  Builds and caches stay under ``build/`` of
the checkout.
"""

from __future__ import annotations

import time

STARTED = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
BUILD = ROOT / "build" / "meterbench"
FORBIDDEN = {"jax", "jaxlib", "flax", "openmeters_tpu"}
PORT = "openmeters_tpu_torch"


def fail(msg: str, code: int = 1):
    print(f"meterbench: {msg}", file=sys.stderr, flush=True)
    sys.exit(code)


def forbidden_modules() -> list[str]:
    """Top-level names in ``sys.modules`` that must not be loaded,
    compared whole (the port's name begins with the JAX package's)."""
    return sorted({name.split(".")[0] for name in list(sys.modules)} & FORBIDDEN)


def card() -> dict:
    import torch

    out = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": 1}
    try:
        out["power_limit"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader", "-i", "0"],
            capture_output=True, text=True, timeout=20,
        ).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        pass
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    if not (ROOT / PORT).is_dir():
        fail(f"the port ({PORT}/) is not in {ROOT}", 2)
    sys.path.insert(0, str(ROOT))
    BUILD.mkdir(parents=True, exist_ok=True)
    # every cache the run might fill stays in the checkout
    os.environ.setdefault("TRITON_CACHE_DIR", str(BUILD / "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(BUILD / "torch_extensions"))
    os.environ["USE_FLAX"] = "0"

    import importlib

    from meterbench import check, manifest, readings, trace as tracemod

    cell = manifest.cell(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        fail(f"{args.workload} needs {cell.chips} CUDA device(s); found "
             f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", 3)
    kind = cell.traffic["kind"]
    if not kind.isidentifier() or not (ROOT / "meterbench" / f"{kind}.py").exists():
        fail(f"traffic kind {kind!r} has no module meterbench/{kind}.py", 2)
    runner = importlib.import_module(f"meterbench.{kind}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    run_ = runner.run(cell, args.seed, args.seconds, bool(args.trace), "cuda:0", STARTED,
                      trace_path=BUILD / "trace.json")
    result_metrics, device = {}, {**card(), "memory_peak_bytes": run_.memory_peak_bytes}
    breakdown = None
    if args.trace:
        tr = tracemod.load(run_.profile["path"], run_.profile["hops"]) if run_.profile else None
        ctx = readings.Context(cell, run_.n_streams, run_.hops, run_.fetches, run_.spans, tr)
        for m in cell.per_layer:
            value = manifest.metric_reader(m["name"]).read(ctx)
            if value is not None:
                result_metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        if tr is not None:
            device.update(busy_s=tr.busy_s, window_s=tr.window_s)
            breakdown = {"device_ops": tr.top_ops(), "idle_gaps": tr.idle_gaps()}
    else:
        e2e = runner.end_to_end(run_)
        for m in cell.end_to_end:
            result_metrics[m["name"]] = {"value": e2e[m["name"]], "unit": m["unit"]}

    found_numbers = check.numbers(cell, run_, lambda k, n: runner.samples(run_, k, n))
    limits = cell.config["limits"]
    correct = check.verdict(found_numbers, limits)
    found = forbidden_modules()
    if found:
        fail(f"loaded in this process: {', '.join(found)}", 4)
    attempted = run_.hops * run_.n_streams
    failed = run_.resets + run_.underruns + run_.pushes_refused
    print(f"meterbench: {args.workload} seed {args.seed}: {run_.hops} hops, {run_.fetches} fetches in "
          f"{run_.window_s:.3f} s; resets {run_.resets}, underruns {run_.underruns}, refused pushes "
          f"{run_.pushes_refused}; host ms a hop: "
          + ", ".join(f"{k} {v / max(run_.hops, 1) * 1e3:.3f}" for k, v in run_.spans.items())
          + f"; streams checked {len(run_.sampled)} over "
          f"{len(run_.drained_hops) + 1} hops",
          file=sys.stderr)
    for name, value in found_numbers.items():
        print(f"check {name} = {value!r} (limit {limits[name]!r})", file=sys.stderr)
    print(f"check correct = {correct}", file=sys.stderr, flush=True)
    line = {"correct": correct, "attempted": attempted, "failed": failed, "metrics": result_metrics,
            "device": device}
    if breakdown is not None:
        line["breakdown"] = breakdown
    line["check"] = {k: {"value": v, "limit": limits[k]} for k, v in found_numbers.items()}
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""The cost of the program's host spans (``tracing.span``), and the host
time a hop and the device's idle time split by span in a trace of the
served benchmark.

    python tools/spans.py cost
    python tools/spans.py split TRACE HOPS

``cost`` times ``span`` entered and left in a loop, with no profiler
running and under ``torch.profiler`` (the card's activity too where there
is a card), less the loop itself; beside it the check the span makes, the
``perf_counter`` pair and sum that a span with ``into`` wraps, and a
``record_function`` entered with no profiler running (what an unguarded
span would cost).  ``split`` reads the Chrome trace of
``meterbench/run.py --trace 1`` (``build/meterbench/trace.json``, HOPS the
profiled hops): the stretch's wall time a hop, each span's time a hop and
its own time (less the spans inside it), the share of the stretch's idle time that a program span
covers, and that idle time by its innermost program span.  One JSON object
a line.
"""

from __future__ import annotations

import bisect
import collections
import json
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
PREFIXES = ("serve.", "ingest.", "engine.", "analyzers.")


def _per_iter_us(body, n: int) -> float:
    t = time.perf_counter()
    for _ in range(n):
        body()
    return (time.perf_counter() - t) / n * 1e6


def cost(n_off: int = 200_000, n_on: int = 20_000) -> dict:
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from openmeters_tpu_torch.tracing import span

    seconds = {"k": 0.0}

    def empty():
        pass

    def plain():
        with span("serve.hop"):
            pass

    def timed():
        with span("serve.step", seconds, "k"):
            pass

    def nested():
        with span("serve.step", seconds, "k"):
            with span("engine.step"):
                pass

    def timer():  # the arithmetic alone that a span with ``into`` does
        t = time.perf_counter()
        seconds["k"] += time.perf_counter() - t

    def unguarded():
        with record_function("serve.hop"):
            pass

    check = torch._C._autograd._profiler_enabled
    for body in (empty, plain, timed, timer, nested, unguarded):
        _per_iter_us(body, 1000)  # warm
    base = _per_iter_us(empty, n_off)
    out = {
        "check_us": _per_iter_us(check, n_off) - base,
        "off_span_us": _per_iter_us(plain, n_off) - base,
        "off_span_into_us": _per_iter_us(timed, n_off) - base,
        "off_timer_us": _per_iter_us(timer, n_off) - base,
        "off_nested_pair_us": _per_iter_us(nested, n_off) - base,
        "off_record_function_us": _per_iter_us(unguarded, n_off // 10) - base,
    }
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
    with profile(activities=acts):
        for name, body in (("on_span_us", plain), ("on_span_into_us", timed), ("on_nested_pair_us", nested)):
            out[name] = _per_iter_us(body, n_on) - base
    out["device"] = torch.cuda.get_device_name(0) if torch.cuda.is_available() else "cpu"
    return out


def _program(name: str) -> bool:
    return name.startswith(PREFIXES)


def split(path: str, hops: int) -> dict:
    from meterbench import stats, trace as tracemod

    tr = tracemod.load(path, hops)
    spans = sorted(((max(s, tr.start), min(e, tr.end), n) for s, e, n in tr.host
                    if _program(n) and e > tr.start and s < tr.end), key=lambda x: (x[0], -x[1]))
    total = collections.Counter()
    own = collections.Counter()
    count = collections.Counter()
    for k, (s, e, n) in enumerate(spans):
        total[n] += e - s
        count[n] += 1
        # the spans directly inside: contained, and in no other contained span
        inner = [x for x in spans[k + 1:] if x[0] >= s and x[1] <= e and x != (s, e, n)]
        direct = [x for x in inner if not any(y is not x and y[0] <= x[0] and x[1] <= y[1] for y in inner)]
        own[n] += (e - s) - sum(x[1] - x[0] for x in direct)
    idle = stats.gaps(stats.union((s, e) for s, e, _ in tr.device), tr.start, tr.end)
    idle_us = sum(e - s for s, e in idle)
    cuts = sorted({t for s, e, _ in spans for t in (s, e)} | {t for s, e in idle for t in (s, e)})
    starts = [s for s, _ in idle]
    by_span = collections.Counter()
    for a, b in zip(cuts, cuts[1:]):
        mid = 0.5 * (a + b)
        g = bisect.bisect_right(starts, mid) - 1
        if g < 0 or mid >= idle[g][1]:
            continue  # the device is busy here
        around = [(e - s, n) for s, e, n in spans if s <= mid <= e]
        by_span[min(around)[1] if around else "(outside every program span)"] += b - a
    covered = idle_us - by_span["(outside every program span)"]
    return {
        "hops": hops,
        "fetches": count["serve.drain"],
        "stretch_ms_a_hop": (tr.end - tr.start) / hops * 1e-3,
        "ms_a_hop": {n: total[n] / hops * 1e-3 for n in sorted(total)},
        "own_ms_a_hop": {n: own[n] / hops * 1e-3 for n in sorted(own)},
        "count": dict(sorted(count.items())),
        "idle_ms": idle_us * 1e-3,
        "idle_in_program_span_share": covered / idle_us if idle_us else None,
        "idle_ms_by_innermost_span": {n: v * 1e-3 for n, v in by_span.most_common()},
    }


def main(argv) -> int:
    if argv[:1] == ["cost"]:
        print(json.dumps(cost()))
    elif argv[:1] == ["split"] and len(argv) == 3:
        print(json.dumps(split(argv[1], int(argv[2]))))
    else:
        print(__doc__, file=sys.stderr)
        return 2
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

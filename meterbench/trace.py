"""Reading a ``torch.profiler`` trace (Chrome's format) of the profiled
stretch: device activity, its union, the idle gaps and what the host did
in them."""

from __future__ import annotations

import collections
import dataclasses
import json

from meterbench import stats

DEVICE_CATS = {"kernel", "gpu_memcpy", "gpu_memset"}
HOST_CATS = {"cpu_op", "user_annotation", "cuda_runtime", "cuda_driver", "python_function"}
SPAN = "meterbench.profiled"
NAME_CHARS = 96  # kernel names are cut here in the breakdown (template signatures run to kilobytes)


@dataclasses.dataclass
class Trace:
    start: float  # µs, the profiled span
    end: float
    hops: int
    device: list  # [(start, end, name)] µs, clipped to the span
    host: list  # [(start, end, name)] µs

    @property
    def window_s(self) -> float:
        return (self.end - self.start) * 1e-6

    @property
    def busy_s(self) -> float:
        return stats.covered((s, e) for s, e, _ in self.device) * 1e-6


    def top_ops(self, k: int = 10) -> list:
        total = collections.Counter()
        for s, e, n in self.device:
            total[n[:NAME_CHARS]] += (e - s) * 1e-6
        return [[n, v] for n, v in total.most_common(k)]

    def idle_gaps(self, k: int = 10) -> list:
        """The ``k`` longest idle stretches, each named by the innermost
        host event around its middle."""
        merged = stats.union((s, e) for s, e, _ in self.device)
        out = []
        for g0, g1 in sorted(stats.gaps(merged, self.start, self.end), key=lambda g: g[0] - g[1])[:k]:
            mid = 0.5 * (g0 + g1)
            around = [(e - s, n) for s, e, n in self.host if s <= mid <= e]
            out.append([min(around)[1] if around else "(no host event)", (g1 - g0) * 1e-6])
        return out


def load(path, hops: int) -> Trace:
    events = json.loads(open(path).read())
    events = events["traceEvents"] if isinstance(events, dict) else events
    span = [e for e in events if e.get("name") == SPAN and e.get("cat") == "user_annotation"]
    if not span:
        raise ValueError(f"{path}: no {SPAN} span")
    lo = float(span[0]["ts"])
    hi = lo + float(span[0]["dur"])
    device, host = [], []
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        s, d = float(e["ts"]), float(e["dur"])
        if e.get("cat") in DEVICE_CATS:
            if s + d > lo and s < hi:
                device.append((max(s, lo), min(s + d, hi), e.get("name", "?")))
        elif e.get("cat") in HOST_CATS and e.get("name") != SPAN:
            host.append((s, s + d, e.get("name", "?")))
    return Trace(lo, hi, hops, device, host)

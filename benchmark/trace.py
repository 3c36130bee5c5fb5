"""Reading a ``torch.profiler`` trace of the traced steps: the card's busy
time inside the traced window (``chip_smoke.py``'s ``device_busy_share``),
the kernels it ran with their device times, and the longest idle gaps
named by what the host was doing.

The profiler records the card's activity alone: recording every host
operation as well costs the host more than a millisecond a step, which
would read as idle card time. The host's own spans (the window, each wait
on the loader, each step's dispatch) are taken with ``time.time_ns()``,
the clock the profiler's timestamps count from
(``kineto_results.trace_start_ns()`` plus an event's microseconds)."""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Sequence, Tuple

# device events that move or fill memory rather than run a kernel
NOT_KERNELS = ("Memcpy", "Memset")


def _merge(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def summarize(prof, window: Tuple[int, int],
              host_spans: Sequence[Tuple[str, int, int]]) -> Dict:
    """What the traced window ``(start, end)`` (``time.time_ns()``) shows,
    in seconds: ``span_s`` (its length), ``busy_s`` (the union of the
    card's kernels, copies and fills inside it), ``kernels`` (``[(name,
    device seconds)]`` of every kernel inside it), ``device_ops`` (the 10
    names with the most device time) and ``idle_gaps`` (the 10 longest
    gaps between device work, each named by the innermost of
    ``host_spans`` (``(name, start, end)``) open at its middle, else
    ``other``)."""
    from torch.autograd import DeviceType

    t0 = prof.profiler.kineto_results.trace_start_ns()
    lo, hi = window
    dev = []
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        a = max(t0 + int(e.time_range.start * 1000), lo)
        b = min(t0 + int(e.time_range.end * 1000), hi)
        if b > a:
            dev.append((e.name, a, b))
    busy = _merge([(a, b) for _, a, b in dev])
    kernels = [(n, (b - a) / 1e9) for n, a, b in dev
               if not n.startswith(NOT_KERNELS)]
    by_name: Dict[str, float] = defaultdict(float)
    for n, a, b in dev:
        by_name[n] += (b - a) / 1e9
    gaps: List[Tuple[str, float]] = []
    edges = [lo] + [x for iv in busy for x in iv] + [hi]
    for a, b in zip(edges[0::2], edges[1::2]):
        if b <= a:
            continue
        mid = (a + b) / 2
        open_ = [m for m in host_spans if m[1] <= mid <= m[2]]
        name = (min(open_, key=lambda m: m[2] - m[1])[0] if open_
                else "other")
        gaps.append((name, (b - a) / 1e9))
    gaps.sort(key=lambda g: -g[1])
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    return dict(span_s=(hi - lo) / 1e9,
                busy_s=sum(b - a for a, b in busy) / 1e9,
                kernels=kernels,
                device_ops=[[n, s] for n, s in top],
                idle_gaps=[[n, s] for n, s in gaps[:10]])

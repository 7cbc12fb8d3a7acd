"""The traced run's device timeline, read from a ``torch.profiler`` run.

The harness wraps its measured window in a profiler with CPU and CUDA
activity and its own ``record_function`` spans: ``bench.window`` around the
window and ``bench.search`` around each search call.  The profiler's events
are read in memory (no trace file is written).  What the card did are its
``kernel``, ``gpu_memcpy`` and ``gpu_memset`` events; what the host did are
its ``cpu_op``, ``cuda_runtime``, ``cuda_driver`` and ``user_annotation``
events.  Times are in microseconds of the profiler's clock.
"""

from __future__ import annotations

import bisect
import dataclasses
from collections import defaultdict

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver", "user_annotation")
WINDOW, SEARCH = "bench.window", "bench.search"


@dataclasses.dataclass
class Trace:
    window: tuple            # (start, end) of the window span
    searches: list           # (start, end) of each search span, in order
    device: dict             # card index -> sorted [(start, end, name)]
    host: list               # sorted [(start, end, name)] of the main thread
    events: int              # events the profiler recorded

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) * 1e-6


def _category(ev) -> str:
    """An event's Chrome trace category.  Releases of torch whose events do
    not tell it apart: a device event is a kernel, a copy or a fill unless
    it is a span of the harness, and a host event an operator."""
    if hasattr(ev, "activity_type"):
        return ev.activity_type()
    from torch.autograd import DeviceType

    if ev.device_type() == DeviceType.CPU:
        return "cpu_op"
    return "gpu_user_annotation" if ev.name() in (WINDOW, SEARCH) else "kernel"


def from_profiler(prof) -> Trace:
    """The trace of a stopped ``torch.profiler.profile``."""
    events = prof.profiler.kineto_results.events()
    device = defaultdict(list)
    host = []
    for ev in events:
        cat = _category(ev)
        if cat in DEVICE_CATS:
            device[ev.device_index()].append(
                (ev.start_ns() * 1e-3, ev.end_ns() * 1e-3, ev.name()))
        elif cat in HOST_CATS:
            host.append((ev.start_ns() * 1e-3, ev.end_ns() * 1e-3, ev.name(),
                         ev.start_thread_id()))
    windows = [h for h in host if h[2] == WINDOW]
    if len(windows) != 1:
        raise ValueError(f"trace holds {len(windows)} {WINDOW} spans")
    window, main = windows[0][:2], windows[0][3]
    searches = sorted(h[:2] for h in host if h[2] == SEARCH)
    return Trace(
        window=window, searches=searches,
        device={d: sorted(v) for d, v in device.items()},
        host=sorted(h[:3] for h in host if h[3] == main),
        events=len(events))


def union(intervals, lo: float, hi: float) -> float:
    """Microseconds of [lo, hi] that sorted ``intervals`` cover."""
    busy, end = 0.0, lo
    for s, e, *_ in intervals:
        if e <= end:
            continue
        if s >= hi:
            break
        s = max(s, end)
        e = min(e, hi)
        if e > s:
            busy += e - s
            end = e
    return busy


def gaps(intervals, lo: float, hi: float):
    """The idle stretches (start, end) of [lo, hi] between ``intervals``."""
    out, end = [], lo
    for s, e, *_ in intervals:
        if s >= hi:
            break
        if s > end:
            out.append((end, s))
        end = max(end, e)
    if end < hi:
        out.append((end, hi))
    return out


def matching(intervals, names):
    """The intervals whose name holds one of ``names``."""
    return [iv for iv in intervals if any(n in iv[2] for n in names)]


def within(intervals, lo: float, hi: float):
    """The sorted intervals that start in [lo, hi)."""
    starts = [iv[0] for iv in intervals]
    return intervals[bisect.bisect_left(starts, lo):
                     bisect.bisect_left(starts, hi)]


def top_device_ops(trace: Trace, n: int = 10):
    """[name, seconds] of the ``n`` device operations that took most time
    in the window, summed over the cards."""
    lo, hi = trace.window
    total = defaultdict(float)
    for ivs in trace.device.values():
        for s, e, name in ivs:
            if e > lo and s < hi:
                total[name] += (min(e, hi) - max(s, lo)) * 1e-6
    return [[k, v] for k, v in sorted(total.items(), key=lambda kv: -kv[1])
            [:n]]


def idle_by_host(trace: Trace, n: int = 10):
    """[what the host was doing, seconds] of the cards' idle time in the
    window, summed over the cards: each idle stretch goes to the innermost
    host event of the main thread open at its middle ("python" where none
    but the spans is)."""
    lo, hi = trace.window
    mids = []
    for ivs in trace.device.values():
        for s, e in gaps(ivs, lo, hi):
            mids.append(((s + e) / 2, e - s))
    mids.sort()
    total = defaultdict(float)
    # Sweep the host events (nested on one thread) and the midpoints
    # together, keeping the events open at each point on a stack.
    stack, i = [], 0
    host = trace.host
    for mid, dur in mids:
        while i < len(host) and host[i][0] <= mid:
            while stack and stack[-1][1] <= host[i][0]:
                stack.pop()
            stack.append(host[i])
            i += 1
        while stack and stack[-1][1] < mid:
            stack.pop()
        name = stack[-1][2] if stack else "python"
        if name in (WINDOW, SEARCH):
            name = "python"
        total[name] += dur * 1e-6
    return [[k, v] for k, v in sorted(total.items(), key=lambda kv: -kv[1])
            [:n]]

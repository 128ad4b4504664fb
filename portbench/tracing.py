"""Spans around the program's layers, and the reduction of a profiler
trace to the numbers the per-layer metrics read.

`Spans` puts a `torch.profiler.record_function` range named `pb.<span>`
around each call listed in a configuration's `spans` (a module and an
attribute of the program, patched for the traced run and restored after
it), and keeps, per span, the work that `roofline/<work>.py` counts from
the call's arguments.

`extract` pulls three lists out of a finished profiler run: the host
ranges of the spans, the host time of every CUDA API call by correlation
id, and every device operation. `reduce_trace` is a pure function of
those lists (the tests drive it with made-up events).
"""

from __future__ import annotations

import bisect
import importlib
import re
from dataclasses import dataclass, field

PREFIX = "pb."
WINDOW = PREFIX + "window"
BATCH = PREFIX + "batch"


class Spans:
    """Context manager: wrap each (module, attr) of `specs` in a named
    record_function range; `work[span]` collects (ops, bytes) a call."""

    def __init__(self, specs: list[dict], work_fns: dict):
        self.specs, self.work_fns = specs, work_fns
        self.work: dict[str, list] = {s["name"]: [] for s in specs}
        self._orig: list = []

    def _wrap(self, fn, name: str, count):
        from torch.profiler import record_function

        sink = self.work[name]

        def wrapped(*a, **kw):
            if count is not None:
                sink.append(count(*a, **kw))
            with record_function(PREFIX + name):
                return fn(*a, **kw)

        return wrapped

    def __enter__(self):
        for s in self.specs:
            mod = importlib.import_module(s["module"])
            fn = getattr(mod, s["attr"])
            self._orig.append((mod, s["attr"], fn))
            count = self.work_fns[s["work"]].work if s.get("work") else None
            setattr(mod, s["attr"], self._wrap(fn, s["name"], count))
        return self

    def __exit__(self, *exc):
        for mod, attr, fn in reversed(self._orig):
            setattr(mod, attr, fn)
        self._orig.clear()


@dataclass
class Events:
    spans: list = field(default_factory=list)  # (name, start_ns, end_ns)
    api: dict = field(default_factory=dict)  # correlation id -> host start_ns of the CUDA call
    device: list = field(default_factory=list)  # (name, start_ns, end_ns, correlation id)


def extract(prof) -> Events:
    """The events of a finished torch.profiler run (its kineto results)."""
    out = Events()
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        if str(e.device_type()).endswith("CUDA"):
            if not name.startswith(PREFIX):  # not the device copy of a span
                out.device.append((name, e.start_ns(), e.end_ns(), e.correlation_id()))
        elif name.startswith(PREFIX):
            out.spans.append((name[len(PREFIX):], e.start_ns(), e.end_ns()))
        elif name.startswith("cu"):  # the CUDA runtime and driver calls
            out.api[e.correlation_id()] = e.start_ns()
    return out


def _union(intervals: list) -> list:
    merged: list = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            if e > merged[-1][1]:
                merged[-1][1] = e
        else:
            merged.append([s, e])
    return merged


def is_kernel(name: str) -> bool:
    return not name.startswith(("Memcpy", "Memset", "memcpy", "memset"))


def port_kernel_names(csrc) -> set[str]:
    """The names of the program's own __global__ functions, read from its
    CUDA sources, so that a kernel a later change adds is counted too."""
    pat = re.compile(r"__global__\s+void\s+(?:__launch_bounds__\s*\([^)]*\)\s*)?([A-Za-z_]\w*)\s*\(")
    names = set()
    for path in sorted(csrc.glob("*.cu*")):
        names.update(pat.findall(path.read_text()))
    return names


def _is_port(name: str, port: set[str]) -> bool:
    return any(re.search(rf"\b{re.escape(k)}\b", name) for k in port)


def reduce_trace(ev: Events, port: set[str], top: int = 10) -> dict:
    """The traced window's numbers: its length and device busy time, the
    device time of the kernels each span launched (`span_device_s`, nested
    spans included), the kernels each span launched while no span nested in
    it was open (`span_own`: their count, device time, and device time
    outside the port's own kernels), each span's host time, the kernels of
    the whole window, the top device operations and the idle gaps by the
    span the host was in."""
    window_name = WINDOW[len(PREFIX):]
    windows = [(s, e) for n, s, e in ev.spans if n == window_name]
    if not windows:
        raise ValueError("the trace has no window span")
    w0, w1 = min(s for s, _ in windows), max(e for _, e in windows)
    dev = [(n, max(s, w0), min(e, w1), c) for n, s, e, c in ev.device if e > w0 and s < w1]
    busy = _union([(s, e) for _, s, e, _ in dev if e > s])
    busy_ns = sum(e - s for s, e in busy)

    by_span: dict[str, list] = {}
    host_ns: dict[str, int] = {}
    for n, s, e in ev.spans:
        by_span.setdefault(n, []).append((s, e))
        host_ns[n] = host_ns.get(n, 0) + (e - s)
    starts = {n: sorted(v) for n, v in by_span.items()}
    span_dev_ns = {n: 0 for n in starts}
    own = {n: {"kernels": 0, "device_ns": 0, "plain_ns": 0} for n in starts}
    unmatched = 0
    kernels = 0
    port_memo: dict[str, bool] = {}
    by_op: dict[str, int] = {}
    for n, s, e, c in dev:
        d = e - s
        by_op[n] = by_op.get(n, 0) + d
        kernel = is_kernel(n)
        if kernel:
            kernels += 1
            if n not in port_memo:
                port_memo[n] = _is_port(n, port)
        t = ev.api.get(c)
        if t is None:
            unmatched += 1
            continue
        inner, inner_key = None, None
        for sn, iv in starts.items():
            i = bisect.bisect_right(iv, (t, float("inf"))) - 1
            if i >= 0 and iv[i][0] <= t <= iv[i][1]:
                span_dev_ns[sn] += d
                key = (sn != window_name, iv[i][0], -iv[i][1])  # a layer's span over the window; then the latest start, the earliest end
                if inner_key is None or key > inner_key:
                    inner, inner_key = sn, key
        if inner is not None and kernel:
            own[inner]["kernels"] += 1
            own[inner]["device_ns"] += d
            if not port_memo[n]:
                own[inner]["plain_ns"] += d

    # idle gaps inside the window, each named by the innermost span open
    # on the host at the gap's middle
    gaps = []
    prev = w0
    for s, e in busy + [[w1, w1]]:
        if s > prev:
            gaps.append((prev, s))
        prev = max(prev, e)
    flat = sorted((s, e, n) for n, s, e in ev.spans if n != window_name)
    idle_by: dict[str, int] = {}
    for g0, g1 in gaps:
        mid = (g0 + g1) // 2
        inner = [(e - s, n) for s, e, n in flat if s <= mid <= e]
        label = min(inner)[1] if inner else "outside any span"
        idle_by[label] = idle_by.get(label, 0) + (g1 - g0)
    return {
        "window_s": (w1 - w0) / 1e9,
        "busy_s": busy_ns / 1e9,
        "kernels": kernels,
        "span_device_s": {n: v / 1e9 for n, v in span_dev_ns.items()},
        "span_own": {n: {"kernels": v["kernels"], "device_s": v["device_ns"] / 1e9, "plain_device_s": v["plain_ns"] / 1e9}
                     for n, v in own.items()},
        "span_host_s": {n: v / 1e9 for n, v in host_ns.items()},
        "span_calls": {n: len(v) for n, v in by_span.items()},
        "unmatched_device_ops": unmatched,
        "device_ops": [[n[:120], v / 1e9] for n, v in sorted(by_op.items(), key=lambda kv: -kv[1])[:top]],
        "idle_gaps": [[n, v / 1e9] for n, v in sorted(idle_by.items(), key=lambda kv: -kv[1])[:top]],
    }

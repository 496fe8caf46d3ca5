"""What a torch.profiler trace of one sweep says: device intervals, busy
time, kernel times by name, and the device's idle gaps named by what the
host was doing meanwhile.

Reads the profiler's raw event list (no Chrome trace is written), so a
sweep of some hundred thousand events reduces in seconds.
"""

from __future__ import annotations

import re
from collections import Counter, defaultdict


def short_name(name):
    """A kernel's name without its return type, namespaces and arguments."""
    name = re.sub(r"^void\s+", "", name).replace("(anonymous namespace)::",
                                                 "")
    return name.split("(")[0][:120]


def base_name(name):
    """The identifier of a kernel's name: template arguments and
    namespaces dropped."""
    return short_name(name).split("<")[0].split("::")[-1]


def is_copy(name):
    return name.startswith(("Memcpy", "Memset"))


class Trace:
    """The events of one profiled window. ``window_s`` is its length on
    the host's clock."""

    def __init__(self, events, window_s):
        self.window_s = window_s
        dev, host = [], []
        for e in events:
            kind = str(e.device_type())
            s = e.start_ns()
            if kind.endswith("CUDA"):
                dev.append((s, s + e.duration_ns(), e.name()))
            elif kind.endswith("CPU"):
                host.append((s, s + e.duration_ns(), e.name(),
                             e.start_thread_id()))
        dev.sort()
        self.device = dev
        self.kernels = [d for d in dev if not is_copy(d[2])]
        # the host thread that drove the sweep: the one with most events
        main = Counter(h[3] for h in host).most_common(1)
        tid = main[0][0] if main else None
        self.host = sorted((s, t, n) for s, t, n, th in host if th == tid)
        self.busy_ns, self.gaps = _union(dev)

    @property
    def busy_s(self):
        return self.busy_ns / 1e9

    def layer_seconds(self, names):
        """Device seconds of the kernels whose name (without its template
        arguments) is one of ``names``: the union of their intervals."""
        names = set(names)
        sel = [d for d in self.kernels if base_name(d[2]) in names]
        return _union(sel)[0] / 1e9

    def device_ops(self, top=10):
        """[name, seconds] of the device operations that took most time."""
        tot = defaultdict(int)
        for s, t, n in self.device:
            tot[short_name(n)] += t - s
        return [[k, v / 1e9] for k, v in sorted(tot.items(),
                                                key=lambda kv: -kv[1])[:top]]

    def idle_gaps(self, top=10):
        """[name, seconds]: the device's idle gaps summed by the innermost
        host operation running at each gap's middle ("host python" where
        the host ran no recorded operation)."""
        tot = defaultdict(int)
        host, i, stack = self.host, 0, []
        for g0, g1 in self.gaps:
            mid = (g0 + g1) // 2
            while i < len(host) and host[i][0] <= mid:
                stack.append(host[i])
                i += 1
            stack = [h for h in stack if h[1] > mid]
            name = stack[-1][2] if stack else "host python"
            tot[name] += g1 - g0
        return [[k, v / 1e9] for k, v in sorted(tot.items(),
                                                key=lambda kv: -kv[1])[:top]]


def _union(intervals):
    """(covered ns, gaps [(start, end)]) of sorted (start, end, ...)."""
    busy, gaps, end = 0, [], None
    for s, t, *_ in intervals:
        if end is None:
            busy, end = t - s, t
        elif s >= end:
            if s > end:
                gaps.append((end, s))
            busy += t - s
            end = t
        elif t > end:
            busy += t - end
            end = t
    return busy, gaps


def from_profiler(prof, window_s):
    return Trace(prof.profiler.kineto_results.events(), window_s)

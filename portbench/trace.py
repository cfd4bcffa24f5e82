"""The traced window: ``torch.profiler`` over CPU and CUDA activity, read
into plain lists.

``busy_s`` is the union of the device's activity intervals (kernels,
copies, sets; the kernels a CUDA graph's replay runs each appear as
themselves), the idle share is one minus it over the window, as
``tools/step_split.py`` and ``tools/frame_split.py`` read their profiles.
"""
import collections
import time

import torch


class Trace:
    """The device's activities and the host's calls of a traced window,
    each (name, start_us, end_us), and the window's host seconds."""

    def __init__(self, device_events, host_events, window_s):
        self.device = sorted(device_events, key=lambda e: e[1])
        self.host = host_events
        self.window_s = window_s

    def busy_intervals(self):
        """The union of the device's activity, as sorted (start, end)."""
        out = []
        for _, s, e in self.device:
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return out

    def busy_s(self):
        return sum(e - s for s, e in self.busy_intervals()) / 1e6

    def idle_share(self):
        """The share of the window in which no operation ran on the
        device, in %."""
        return 100.0 * (1.0 - self.busy_s() / self.window_s)

    def kernel_s(self, names):
        """Device seconds of the activities whose name contains one of
        ``names``, and how many there were."""
        picked = [e - s for n, s, e in self.device
                  if any(k in n for k in names)]
        return sum(picked) / 1e6, len(picked)

    def device_ops(self, top=10):
        """[name, seconds] of the device operations that took most time."""
        by = collections.Counter()
        for n, s, e in self.device:
            by[n[:120]] += (e - s) / 1e6
        return [[n, t] for n, t in by.most_common(top)]

    def idle_gaps(self, top=10):
        """[host activity, seconds] of the device's idle gaps between its
        first and last activity, summed by the innermost host call under
        way at each gap's middle."""
        gaps = collections.Counter()
        busy = self.busy_intervals()
        host = sorted(self.host, key=lambda e: e[1])
        i, open_calls = 0, []
        for (_, a), (b, _) in zip(busy, busy[1:]):
            mid = 0.5 * (a + b)
            while i < len(host) and host[i][1] <= mid:
                open_calls.append(host[i])
                i += 1
            # the middles grow: a call that ended before one stays ended
            open_calls = [c for c in open_calls if c[2] >= mid]
            name = open_calls[-1][0] if open_calls else "(no host call)"
            gaps[name[:120]] += (b - a) / 1e6
        return [[n, t] for n, t in gaps.most_common(top)]


def traced(fn, device):
    """(fn's result, :class:`Trace`) of ``fn()`` under the profiler, the
    device synchronised before and after; on the CPU no device events."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
        torch.cuda.synchronize(device)
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        out = fn()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        window_s = time.perf_counter() - t0
    dev_events, host_events = [], []
    for e in prof.events():
        rng = (e.name, e.time_range.start, e.time_range.end)
        if e.device_type == torch.autograd.DeviceType.CUDA:
            dev_events.append(rng)
        else:
            host_events.append(rng)
    return out, Trace(dev_events, host_events, window_s)

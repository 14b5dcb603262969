"""The traced window: ``torch.profiler`` with CPU and CUDA activity over
the whole measured window, reduced in memory to what the readers need.

``busy_s`` is the length of the union of every kernel, copy and set on
the device inside the window (the ``rtbench.window`` range); an idle
gap is a stretch of the window with none of them, named after the
innermost host operation running at its middle.
"""

from __future__ import annotations

from collections import defaultdict

# activity kinds that occupy the device
_DEVICE_KINDS = ("kernel", "memcpy", "memset")


class Trace:
    """Device intervals and host ranges of a traced window, in ns of the
    profiler's clock."""

    def __init__(self, kernels, host, t0, t1):
        self.kernels = kernels      # [(name, start, end)] device activity
        self.host = host            # [(name, start, end)] host operations
        self.t0, self.t1 = t0, t1   # the window
        merged = []
        for _, s, e in sorted((k for k in kernels), key=lambda k: k[1]):
            s, e = max(s, t0), min(e, t1)
            if e <= s:
                continue
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        self.busy = merged
        self.busy_s = sum(e - s for s, e in merged) / 1e9
        self.window_s = (t1 - t0) / 1e9

    def kernel_s(self, patterns) -> float:
        """Device seconds inside the window of the kernels whose name
        holds one of ``patterns``."""
        total = 0
        for name, s, e in self.kernels:
            if any(p in name for p in patterns):
                total += max(0, min(e, self.t1) - max(s, self.t0))
        return total / 1e9

    def kernel_count(self, patterns) -> int:
        return sum(1 for name, s, _ in self.kernels
                   if self.t0 <= s < self.t1
                   and any(p in name for p in patterns))

    def gaps(self):
        """[(start, end)] of the window with nothing on the device."""
        out, cur = [], self.t0
        for s, e in self.busy:
            if s > cur:
                out.append((cur, s))
            cur = max(cur, e)
        if cur < self.t1:
            out.append((cur, self.t1))
        return out

    def host_at(self, times):
        """The innermost host range (the window's thread; nested ranges)
        holding each of the ascending ``times``, or None."""
        events = sorted(self.host, key=lambda h: (h[1], -h[2]))
        out, stack, j = [], [], 0
        for q in times:
            while j < len(events) and events[j][1] <= q:
                while stack and stack[-1][2] < events[j][1]:
                    stack.pop()
                stack.append(events[j])
                j += 1
            while stack and stack[-1][2] < q:
                stack.pop()
            out.append(stack[-1][0] if stack else None)
        return out

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time, and the idle time
        by what the host was doing, each ``[[name, seconds], ...]``."""
        ops = defaultdict(int)
        for name, s, e in self.kernels:
            d = min(e, self.t1) - max(s, self.t0)
            if d > 0:
                ops[name[:160]] += d
        idle = defaultdict(int)
        gaps = self.gaps()
        for (s, e), name in zip(gaps, self.host_at([(a + b) // 2
                                                    for a, b in gaps])):
            if name == "rtbench.call":
                name = "Python inside the call, between operations"
            idle[name[:160] if name else "(no host operation)"] += e - s
        return {
            "device_ops": [[n, v / 1e9] for n, v in sorted(
                ops.items(), key=lambda kv: -kv[1])[:top]],
            "idle_gaps": [[n, v / 1e9] for n, v in sorted(
                idle.items(), key=lambda kv: -kv[1])[:top]],
        }


def _occupies_device(ev, name: str) -> bool:
    """A kernel, copy or set: not a range that ``record_function`` put on
    the device's timeline (torch builds without ``activity_type`` name
    those ranges after the host's)."""
    kind = getattr(ev, "activity_type", None)
    if kind is not None:
        return any(k in str(kind()).lower() for k in _DEVICE_KINDS)
    return not name.startswith("rtbench.")


def start(device):
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    prof = profile(activities=acts, record_shapes=False, with_stack=False,
                   profile_memory=False)
    prof.__enter__()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return prof


def finish(prof) -> Trace:
    prof.__exit__(None, None, None)
    kernels, host = [], []
    t0 = t1 = thread = None
    for ev in prof.profiler.kineto_results.events():
        name = ev.name()
        s = ev.start_ns()
        e = s + ev.duration_ns()
        if str(ev.device_type()).endswith("CUDA"):
            if _occupies_device(ev, name):
                kernels.append((name, s, e))
        elif name == "rtbench.window":
            t0, t1, thread = s, e, ev.start_thread_id()
        else:
            host.append((name, s, e, ev.start_thread_id()))
    if t0 is None:
        raise RuntimeError("the traced window's range is missing")
    host = [(n, s, e) for n, s, e, th in host if th == thread]
    return Trace(kernels, host, t0, t1)

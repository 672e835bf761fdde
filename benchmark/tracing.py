"""The traced window: `torch.profiler` over the frames of one session, and
its reduction to what the per-layer readers take.

The reduction keeps the host's spans (`record_function` ranges: the
program's `port.*` and the benchmark's `bench.*`), the device's operations
(kernels, copies and fills) and, for each kernel, the time its launch was
issued on the host, so that a kernel counts under the span that launched
it. A reader (`metrics/<name>.py`) gets a `Window` and returns a number or
None when it finds nothing to read.
"""

from __future__ import annotations

import bisect
from dataclasses import dataclass, field

_DEVICE_OPS = ("kernel", "gpu_memcpy", "gpu_memset")
_SPANS = ("port.", "bench.")


def _kind(e) -> str | None:
    """"span" (a host `record_function` range of the program's or the
    benchmark's), "launch" (a CUDA runtime or driver call), "kernel",
    "gpu_memcpy", "gpu_memset", or None for anything else. Where the
    event has no activity type (older PyTorch), the device and the name
    decide."""
    act = e.activity_type() if hasattr(e, "activity_type") else None
    name = e.name()
    on_device = "CUDA" in str(e.device_type())
    if act is not None:
        if act == "user_annotation":
            return "span" if name.startswith(_SPANS) else None
        if act in ("cuda_runtime", "cuda_driver"):
            return "launch"
        return act if act in _DEVICE_OPS else None
    if name.startswith(_SPANS):
        return None if on_device else "span"
    if not on_device:
        return "launch" if name.startswith("cu") and \
            e.correlation_id() > 0 else None
    if name.startswith("Memcpy"):
        return "gpu_memcpy"
    if name.startswith("Memset"):
        return "gpu_memset"
    return "kernel"


def _times(e) -> tuple[int, int]:
    if hasattr(e, "start_ns"):
        s = e.start_ns()
        return s, s + e.duration_ns()
    s = int(e.start_us() * 1000)
    return s, s + int(e.duration_us() * 1000)


def union(intervals) -> list[tuple[int, int]]:
    """Sorted, merged (start, end) intervals."""
    out: list[list[int]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def length(intervals) -> int:
    return sum(b - a for a, b in union(intervals))


@dataclass
class Window:
    """One traced window, times in nanoseconds on the host's clock."""

    start: int
    end: int
    spans: dict = field(default_factory=dict)  # name → [(start, end)]
    # (start, end, name, launch time on the host or None, kind)
    ops: list = field(default_factory=list)
    frames: int = 0
    keyframes: int = 0
    flops: float = 0.0  # network operations dispatched in the window
    peak_flops: float | None = None

    @property
    def seconds(self) -> float:
        return (self.end - self.start) * 1e-9

    def span_time(self, *prefixes) -> int:
        """Wall time covered by spans whose names start with a prefix."""
        return length(iv for n, ivs in self.spans.items()
                      if n.startswith(prefixes) for iv in ivs)

    def span_count(self, name: str) -> int:
        return len(self.spans.get(name, ()))

    def kernels(self):
        return [o for o in self.ops if o[4] == "kernel"]

    def device_time_under(self, *prefixes) -> int:
        """Device time of the kernels launched inside spans whose names
        start with a prefix."""
        ivs = union(iv for n, ivs in self.spans.items()
                    if n.startswith(prefixes) for iv in ivs)
        starts = [a for a, _ in ivs]
        total = 0
        for s, e, _, launch, kind in self.ops:
            if kind != "kernel" or launch is None:
                continue
            k = bisect.bisect_right(starts, launch) - 1
            if k >= 0 and launch <= ivs[k][1]:
                total += e - s
        return total

    def busy(self) -> int:
        return length((max(s, self.start), min(e, self.end))
                      for s, e, *_ in self.ops if e > self.start
                      and s < self.end)

    def innermost(self) -> list[tuple[int, int, str]]:
        """The window cut into segments, each named by the innermost host
        span open over it ("(no span)" where none is)."""
        spans = sorted(((a, b, n) for n, ivs in self.spans.items()
                        for a, b in ivs), key=lambda x: (x[0], -x[1]))
        segs, stack, cur = [], [], self.start

        def emit(upto):
            nonlocal cur
            if upto > cur:
                segs.append((cur, upto, stack[-1][2] if stack
                             else "(no span)"))
                cur = upto

        for a, b, n in spans:
            while stack and stack[-1][1] <= a:
                emit(stack[-1][1])
                stack.pop()
            emit(a)
            stack.append((a, b, n))
        while stack:
            emit(stack[-1][1])
            stack.pop()
        emit(self.end)
        return segs

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time, and the idle gaps of
        the device summed by the innermost host span open at each gap."""
        by_op: dict[str, int] = {}
        for s, e, name, *_ in self.ops:
            by_op[name] = by_op.get(name, 0) + e - s
        ops = sorted(by_op.items(), key=lambda kv: -kv[1])[:top]
        busy = union((max(s, self.start), min(e, self.end))
                     for s, e, *_ in self.ops if e > self.start
                     and s < self.end)
        gaps, t = [], self.start
        for a, b in busy:
            if a > t:
                gaps.append((t, a))
            t = max(t, b)
        if self.end > t:
            gaps.append((t, self.end))
        by_span: dict[str, int] = {}
        segs = self.innermost()
        k = 0
        for a, b in gaps:
            while k < len(segs) and segs[k][1] <= a:
                k += 1
            i = k
            while i < len(segs) and segs[i][0] < b:
                s, e, n = segs[i]
                ov = min(b, e) - max(a, s)
                if ov > 0:
                    by_span[n] = by_span.get(n, 0) + ov
                i += 1
        gaps_top = sorted(by_span.items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[n[:120], v * 1e-9] for n, v in ops],
                "idle_gaps": [[n, v * 1e-9] for n, v in gaps_top]}


class Tracer:
    """`torch.profiler` on the host and the card, started and stopped
    around the traced frames."""

    def __init__(self):
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
        self.prof = profile(activities=acts, record_shapes=False,
                            with_stack=False, profile_memory=False)

    def start(self):
        self.prof.start()

    def stop(self, sync):
        sync()
        self.prof.stop()

    def window(self) -> Window:
        """Reduce the trace. The window runs from the first traced frame's
        start to the end of the last frame or of the last device
        operation, whichever is later."""
        events = self.prof.profiler.kineto_results.events()
        spans: dict[str, list] = {}
        launches: dict[int, int] = {}
        ops = []
        lo, hi = None, None
        for e in events:
            kind = _kind(e)
            if kind is None:
                continue
            s, en = _times(e)
            if kind == "span":
                spans.setdefault(e.name(), []).append((s, en))
            elif kind == "launch":
                launches[e.correlation_id()] = s
            else:
                ops.append([s, en, e.name(), e.correlation_id(), kind])
            lo = s if lo is None else min(lo, s)
            hi = en if hi is None else max(hi, en)
        for o in ops:
            o[3] = launches.get(o[3])
        bench = [iv for n, ivs in spans.items() if n.startswith("bench.")
                 for iv in ivs]
        if bench:  # the window is the traced frames
            lo = min(a for a, _ in bench)
            hi = max(max(b for _, b in bench),
                     max((o[1] for o in ops), default=0))
        w = Window(start=lo or 0, end=hi or 0, spans=spans,
                   ops=[tuple(o) for o in ops])
        del events
        return w

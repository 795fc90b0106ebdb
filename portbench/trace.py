"""The traced run: torch.profiler over the window, read into plain lists.

The harness puts a ``record_function`` span around each call into a
layer (the drivers' ``draw``, ``block``, ``steps``, ``refresh``, and the
loop's ``sync``) and one, ``window``, around the whole window. Afterwards
the profiler's device activities (kernels, copies, fills) and those spans
become a Trace, which the per-layer metrics (metrics/) read.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass, field

import torch

SPANS = ("draw", "block", "steps", "resync", "refresh", "sync")
# a device operation's name in the breakdown, cut to this many characters
NAME_CHARS = 120


@dataclass
class Trace:
    """Device activities and host spans of the traced window, in us on the
    profiler's clock, and what the harness knows of the window's blocks."""
    device_ops: list          # (name, start, end, launched)
    spans: list               # (name, start, end)
    window: tuple             # (start, end)
    blocks: int
    B: int
    n_steps: int
    records: list = field(default_factory=list)  # (before, after) a block
    setup: dict = field(default_factory=dict)
    spec: object = None       # the reference's float32 spec (bounds)
    state1: object = None     # the reference's B = 1 state (bounds)

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e6

    def busy_s(self) -> float:
        """Seconds of the window in which some device activity ran."""
        busy, end = 0.0, self.window[0]
        for _, s, e, _ in sorted(self.device_ops, key=lambda o: o[1]):
            s, e = max(s, end), min(e, self.window[1])
            if e > s:
                busy += e - s
                end = e
        return busy / 1e6

    def kernel_s(self, *names) -> tuple[float, int]:
        """(summed device seconds, calls) of the activities whose name
        holds one of ``names``."""
        ops = [e - s for n, s, e, _ in self.device_ops
               if any(k in n for k in names)]
        return sum(ops) / 1e6, len(ops)

    def launched_in_s(self, span) -> float | None:
        """Device seconds of the activities queued while the host was
        inside ``span`` (innermost), or None where no activity's launch
        was recorded."""
        if not any(o[3] is not None for o in self.device_ops):
            return None
        return sum(e - s for _, s, e, t in self.device_ops
                   if t is not None and self.host_at(t) == span) / 1e6

    def span_s(self, name) -> float:
        return sum(e - s for n, s, e in self.spans if n == name) / 1e6

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time, and the longest idle
        gaps named by the host span they started in."""
        by_name = {}
        for n, s, e, _ in self.device_ops:
            by_name[n] = by_name.get(n, 0.0) + (e - s) / 1e6
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        gaps, end = [], self.window[0]
        for _, s, e, _ in sorted(self.device_ops, key=lambda o: o[1]):
            if s > end:
                gaps.append((end, s))
            end = max(end, e)
        if self.window[1] > end:
            gaps.append((end, self.window[1]))
        gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:top]
        return {"device_ops": [[n[:NAME_CHARS], t] for n, t in ops],
                "idle_gaps": [[self.host_at(g[0]), (g[1] - g[0]) / 1e6]
                              for g in gaps]}

    def host_at(self, t) -> str:
        """The innermost span the host was in at time t."""
        inside = [(s, n) for n, s, e in self.spans if s <= t < e]
        return max(inside)[1] if inside else "between spans"


class Tracer:
    """The profiler and the spans; off, every span is a no-op."""

    def __init__(self, on: bool):
        self.on = on
        self.prof = None

    def span(self, name):
        if not self.on:
            return contextlib.nullcontext()
        return torch.profiler.record_function(name)

    @contextlib.contextmanager
    def window(self):
        if not self.on:
            yield
            return
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            with torch.profiler.record_function("window"):
                yield
        self.prof = prof

    def read(self) -> tuple[list, list, tuple]:
        """(device activities, spans, window) from the profile, in us.
        Each activity is (name, start, end, launched), ``launched`` the
        time of the runtime call that queued it (None where the profile
        holds none), matched by CUDA correlation id."""
        dev, spans, window, launches = [], [], None, {}
        cuda = torch.autograd.DeviceType.CUDA
        events = self.prof.profiler.kineto_results.events()
        for e in events:
            if e.device_type() != cuda and e.name().startswith("cuda"):
                launches[e.correlation_id()] = e.start_ns() / 1e3
        for e in events:
            name, start = e.name(), e.start_ns() / 1e3
            end = start + e.duration_ns() / 1e3
            if e.device_type() == cuda:
                # record_function's ranges come back on the device too
                if not e.is_user_annotation() and name not in SPANS \
                        and name != "window":
                    dev.append((name, start, end,
                                launches.get(e.correlation_id())))
            elif name == "window":
                window = (start, end)
            elif name in SPANS:
                spans.append((name, start, end))
        return dev, spans, window

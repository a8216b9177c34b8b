"""The device trace of a measured window (``--trace 1``).

``torch.profiler`` records the host's operations and the device's
activities over the window; the window itself is a ``bench.window`` span
that the cell's loop opens and closes, so both lie on the profiler's clock.
What the device was busy with is the union of its activities' intervals
(overlapping kernels count once), clipped to the window.
"""
from __future__ import annotations

import contextlib
import re
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

WINDOW_SPAN = "bench.window"
TOP = 10


def merged(starts: np.ndarray, ends: np.ndarray
           ) -> Tuple[np.ndarray, np.ndarray]:
    """The union of [start, end) intervals as sorted disjoint segments."""
    if starts.size == 0:
        return starts, ends
    order = np.argsort(starts, kind="stable")
    s, e = starts[order], ends[order]
    reach = np.maximum.accumulate(e)
    # a new segment starts where an interval begins past every earlier end
    new = np.ones(s.size, dtype=bool)
    new[1:] = s[1:] > reach[:-1]
    seg_end = np.append(reach[np.flatnonzero(new)[1:] - 1], reach[-1])
    return s[new], seg_end


def union_seconds(starts: np.ndarray, ends: np.ndarray) -> float:
    """Length of the union of intervals given in nanoseconds, in seconds."""
    seg_s, seg_e = merged(starts, ends)
    return float(np.sum(seg_e - seg_s)) / 1e9


class TraceSummary:
    """The window's device activities and host operations."""

    def __init__(self, window: Tuple[int, int], device: Sequence[tuple],
                 host: Sequence[tuple]):
        self.t0, self.t1 = window
        self.window_s = (self.t1 - self.t0) / 1e9
        names = [d[0] for d in device]
        st = np.array([d[1] for d in device], dtype=np.int64)
        en = np.array([d[2] for d in device], dtype=np.int64)
        keep = (en > self.t0) & (st < self.t1)
        self.names = [n for n, k in zip(names, keep) if k]
        self.starts = np.clip(st[keep], self.t0, self.t1)
        self.ends = np.clip(en[keep], self.t0, self.t1)
        self.host = [h for h in host if h[2] > self.t0 and h[1] < self.t1
                     and h[0] != WINDOW_SPAN]
        self.busy_s = union_seconds(self.starts, self.ends)

    def device_seconds(self, match: Callable[[str], bool]) -> float:
        """Busy seconds of the activities whose name ``match`` accepts."""
        idx = [i for i, n in enumerate(self.names) if match(n)]
        if not idx:
            return 0.0
        return union_seconds(self.starts[idx], self.ends[idx])

    def breakdown(self) -> dict:
        """The device operations that took most time and the longest idle
        gaps, each gap named by the innermost host operation running at
        its middle."""
        total: Dict[str, float] = {}
        for n, s, e in zip(self.names, self.starts, self.ends):
            key = short_name(n)
            total[key] = total.get(key, 0.0) + (e - s) / 1e9
        ops = sorted(total.items(), key=lambda kv: -kv[1])[:TOP]
        seg_s, seg_e = merged(self.starts, self.ends)
        gap_s = np.concatenate([[self.t0], seg_e])
        gap_e = np.concatenate([seg_s, [self.t1]])
        lengths = gap_e - gap_s
        order = np.argsort(-lengths)[:TOP]
        h_st = np.array([h[1] for h in self.host], dtype=np.int64)
        h_en = np.array([h[2] for h in self.host], dtype=np.int64)
        gaps = []
        for i in order:
            if lengths[i] <= 0:
                break
            mid = (gap_s[i] + gap_e[i]) // 2
            name = "no host operation"
            if h_st.size:
                inside = np.flatnonzero((h_st <= mid) & (h_en >= mid))
                if inside.size:
                    j = inside[np.argmax(h_st[inside])]
                    name = short_name(self.host[j][0])
            gaps.append([name, float(lengths[i]) / 1e9])
        return {"device_ops": [[n, float(v)] for n, v in ops],
                "idle_gaps": gaps}


def short_name(name: str, limit: int = 120) -> str:
    """A kernel's name without its return type, namespaces' anonymity and
    argument list, at most ``limit`` characters."""
    short = name.replace("(anonymous namespace)::", "")
    short = re.sub(r"^void\s+", "", short)
    short = re.sub(r"\(.*$", "", short).strip()
    return (short or name)[:limit]


class Tracer:
    """``torch.profiler`` over the measured window; ``span()`` marks it."""

    def __init__(self, enabled: bool):
        self.enabled = enabled
        self.prof = None
        self.summary: Optional[TraceSummary] = None

    def __enter__(self) -> "Tracer":
        if self.enabled:
            import torch
            from torch.profiler import ProfilerActivity, profile
            acts = [ProfilerActivity.CPU]
            if torch.cuda.is_available():
                acts.append(ProfilerActivity.CUDA)
            self.prof = profile(activities=acts, record_shapes=False,
                                with_stack=False, profile_memory=False)
            self.prof.__enter__()
        return self

    def span(self):
        if not self.enabled:
            return contextlib.nullcontext()
        from torch.profiler import record_function
        return record_function(WINDOW_SPAN)

    def __exit__(self, *exc) -> None:
        if self.prof is None:
            return
        self.prof.__exit__(*exc)
        if exc[0] is None:
            self.summary = summarize(self.prof)
        self.prof = None


def _events(prof) -> List[tuple]:
    """(name, is_device, start_ns, end_ns) of every recorded event."""
    out = []
    for e in prof.profiler.kineto_results.events():
        dev = e.device_type().name != "CPU"
        if dev and e.is_user_annotation():     # a span, not work
            continue
        st = int(e.start_ns())
        out.append((e.name(), dev, st, st + int(e.duration_ns())))
    return out


def idle_percent(run) -> Optional[float]:
    """The share of the traced window in which no operation ran on the
    device, in %, or None where the trace saw the device do nothing."""
    if run.trace is None or run.trace.busy_s <= 0:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)


def summarize(prof) -> TraceSummary:
    events = _events(prof)
    spans = [(s, e) for n, dev, s, e in events
             if n == WINDOW_SPAN and not dev]
    if not spans:
        raise RuntimeError(f"the trace holds no {WINDOW_SPAN} span")
    window = (min(s for s, _ in spans), max(e for _, e in spans))
    device = [(n, s, e) for n, dev, s, e in events
              if dev and n != WINDOW_SPAN]
    host = [(n, s, e) for n, dev, s, e in events if not dev]
    return TraceSummary(window, device, host)

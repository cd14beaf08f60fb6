"""What a traced run (``--trace 1``) records, and its reduction.

:class:`Probe` wraps calls into the port's layers from outside, as long
as it is open, the way ``chip_smoke.py``'s ``PhaseTimes`` does:

* ``core/relax.py::build_blocked`` (the layout): host clock, ending in a
  synchronize;
* ``core/sssp.py::_transition`` (the step transition) and
  ``core/sssp.py::_relax_round`` (the relaxation call): a span each, by
  CUDA events on the stream (host clock on the CPU), and a profiler range
  (``bench:transition``, ``bench:relax_call``); the relaxation call also
  adds the round's ``n_relax``, ``n_extended`` and ``n_updates`` to
  device-side sums, with no host read;
* ``core/relax.py::relax_bucket`` (the entry of the ``edge_relax``
  kernels): a profiler range ``bench:relax_kernel``, which claims every
  device operation launched inside it.

:func:`reduce_profile` turns the window's ``torch.profiler`` events into
the device's busy seconds, the device seconds of the relaxation kernels,
the operations that took most time and the idle gaps by what the host
was doing.
"""
import bisect
import contextlib
import dataclasses
import importlib
import time

import torch

ROUND_COUNTERS = ("n_relax", "n_extended", "n_updates")


@dataclasses.dataclass
class TraceData:
    """What a per-layer reader reads (``bench/metrics/<metric>.py``)."""
    window_s: float          # the traced window, host clock
    trees: int               # trees solved in the window (slots of batches)
    spans: dict              # span name -> seconds in the window
    counters: dict           # counter name -> sum over the window
    setup: dict              # set-up part -> seconds
    device: dict             # busy_s, relax_kernel_s (None: not measured)
    peaks: dict              # the card's peak table (bench/peaks.py) or {}


TRACED_SECONDS = 20.0


class Probe:
    """The wrappers of a traced run; see the module docstring."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self.device = device
        self.setup = {}
        self._saved = []
        self.start_window()

    def start_window(self):
        """Forget the spans and sums so far (called as the window opens)."""
        self.spans = {"transition": [], "relax_call": []}
        self.rounds = torch.zeros(len(ROUND_COUNTERS), dtype=torch.float64,
                                  device=self.device)

    def _patch(self, module: str, name: str, wrap):
        mod = importlib.import_module(f"repro_torch.{module}")
        fn = getattr(mod, name)
        self._saved.append((mod, name, fn))
        setattr(mod, name, wrap(fn))

    def __enter__(self):
        self._patch("core.relax", "build_blocked", self._layout)
        self._patch("core.sssp", "_transition",
                    lambda fn: self._span(fn, "transition"))
        self._patch("core.sssp", "_relax_round", self._relax_round)
        self._patch("core.relax", "relax_bucket", _ranged("bench:relax_kernel"))
        return self

    def __exit__(self, *exc):
        """Put the port's functions back."""
        for mod, name, fn in reversed(self._saved):
            setattr(mod, name, fn)
        self._saved.clear()

    def _layout(self, fn):
        def timed(*args, **kw):
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            if self.cuda:
                torch.cuda.synchronize()
            self.setup["layout_build_s"] = (
                self.setup.get("layout_build_s", 0.0)
                + time.perf_counter() - t0)
            return out
        return timed

    def _mark(self):
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            return ev
        return time.perf_counter()

    def _span(self, fn, name):
        def timed(*args, **kw):
            with torch.profiler.record_function(f"bench:{name}"):
                start = self._mark()
                out = fn(*args, **kw)
                self.spans[name].append((start, self._mark()))
            return out
        return timed

    def _relax_round(self, fn):
        timed = self._span(fn, "relax_call")

        def counted(backend, layout, st_, *args, **kw):
            out = timed(backend, layout, st_, *args, **kw)
            before, after = st_.metrics, out.metrics
            self.rounds += torch.stack([
                (getattr(after, f) - getattr(before, f)).sum()
                .to(torch.float64) for f in ROUND_COUNTERS])
            return out
        return counted

    def span_seconds(self) -> dict:
        """Seconds summed over each span's calls (after a synchronize)."""
        def secs(a, b):
            return a.elapsed_time(b) / 1e3 if self.cuda else b - a
        return {name: sum(secs(a, b) for a, b in calls)
                for name, calls in self.spans.items()}

    def round_counters(self) -> dict:
        return {f"round_{f}": float(v)
                for f, v in zip(ROUND_COUNTERS, self.rounds.tolist())}


class Tracer:
    """A traced run: the :class:`Probe` from set-up on, then
    ``torch.profiler`` and the window's counts over the specs that start
    in the window's first ``TRACED_SECONDS`` (the whole window when it is
    shorter); the rest of the window runs with neither.  The profiler's
    processing grows with the events it holds, and this keeps a traced
    run well inside its time limit."""

    def __init__(self, device: torch.device):
        self.device = device
        self.probe = Probe(device).__enter__()
        self.prof = None
        self.recording = False

    def open_window(self) -> float:
        """Start the profiler and the window's counts; returns the window's
        start on the host clock, taken once the profiler runs."""
        from torch.profiler import ProfilerActivity, profile

        from repro_torch.kernels.edge_relax.ops import LAUNCHES
        self.launches = LAUNCHES
        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        self.prof = profile(activities=acts)
        self.prof.start()
        self.probe.start_window()
        LAUNCHES.reset()
        self.counts = torch.zeros(3, dtype=torch.float64, device=self.device)
        self.trees = 0
        self.window = torch.profiler.record_function("bench:window")
        self.window.__enter__()
        self.recording = True
        self.start = time.perf_counter()
        return self.start

    def spec(self):
        """The range around one spec (nothing once the trace is closed)."""
        return torch.profiler.record_function("bench:spec") \
            if self.recording else contextlib.nullcontext()

    def count(self, metrics, n_sources: int) -> None:
        """Add a spec's solve counters (device-side, no host read)."""
        if not self.recording:
            return
        self.counts += torch.stack([metrics.n_relax.sum().double(),
                                    metrics.n_updates.sum().double(),
                                    metrics.n_host_syncs.max().double()])
        self.trees += n_sources

    def after_spec(self, now: float, last: bool) -> None:
        """Close the trace once ``TRACED_SECONDS`` have passed, or at the
        window's last spec.  The spec has ended in a synchronize."""
        if self.recording and (last or now - self.start >= TRACED_SECONDS):
            self.window.__exit__(None, None, None)
            t = time.perf_counter()
            self.prof.stop()
            self.stop_s = time.perf_counter() - t
            self.traced_s = now - self.start
            self.spans = self.probe.span_seconds()
            self.rounds = self.probe.round_counters()
            self.launch_count = sum(vars(self.launches).values())
            self.recording = False
            self.probe.__exit__()

    def data(self, peaks: dict) -> tuple:
        """``(TraceData, the profile's reduction, timings)``, once the
        trace is closed; the profiler's events are dropped."""
        t = time.perf_counter()
        found = reduce_profile(self.prof)
        self.prof = None
        counts = self.counts.tolist()
        data = TraceData(
            window_s=self.traced_s, trees=self.trees, spans=self.spans,
            counters=dict(self.rounds, n_relax=counts[0],
                          n_updates=counts[1], host_syncs=counts[2],
                          launches=self.launch_count),
            setup=dict(self.probe.setup), device=found, peaks=peaks)
        return data, found, {"profiler_stop_s": self.stop_s,
                             "reduce_s": time.perf_counter() - t}


def _ranged(label: str):
    def wrap(fn):
        def ranged(*args, **kw):
            with torch.profiler.record_function(label):
                return fn(*args, **kw)
        return ranged
    return wrap


def _union(intervals):
    """Disjoint, sorted union of ``(start, end)`` pairs."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return out


def _top(totals: dict, k: int = 10) -> list:
    return [[name, secs] for name, secs in
            sorted(totals.items(), key=lambda kv: -kv[1])[:k]]


def _covering(ranges, t):
    """Whether the sorted, disjoint ``ranges`` cover the instant ``t``."""
    i = bisect.bisect_right(ranges, [t, float("inf")]) - 1
    return i >= 0 and ranges[i][0] <= t < ranges[i][1]


def reduce_profile(prof) -> dict:
    """``busy_s``, ``relax_kernel_s``, ``device_ops`` and ``idle_gaps``
    of the ``bench:window`` range of a finished ``torch.profiler`` run.

    Device operations are the profiler's device-side events other than
    range markers (kernels, copies, sets).  A device operation belongs to
    the relaxation kernels when the host call that launched it (matched
    by correlation id) started inside a ``bench:relax_kernel`` range.  An
    idle gap is named by the span the host was in at its midpoint and the
    outermost ``aten`` operation the host was running then (``python``
    when none)."""
    from torch.autograd import DeviceType
    gpu, host_ops, runtime, cpu_ops = [], [], {}, {}
    ranges = {k: [] for k in ("bench:window", "bench:spec", "bench:transition",
                              "bench:relax_call", "bench:relax_kernel")}
    for e in prof.profiler.kineto_results.events():
        name, t0 = e.name(), e.start_ns()
        t1 = t0 + e.duration_ns()
        if e.device_type() != DeviceType.CPU:
            if not name.startswith(("bench:", "repro:")):
                gpu.append((t0, t1, name, e.correlation_id(),
                            e.linked_correlation_id()))
        elif name.startswith("cu"):          # a CUDA runtime or driver call
            runtime[e.correlation_id()] = t0
        else:
            cpu_ops[e.correlation_id()] = t0
            if name in ranges:
                ranges[name].append([t0, t1])
            elif name.startswith("aten::"):
                host_ops.append([t0, t1, name])
    if not ranges["bench:window"]:
        return {}
    w0, w1 = ranges["bench:window"][0]
    gpu = [g for g in gpu if g[0] < w1 and g[1] > w0]
    busy = _union((max(s, w0), min(e, w1)) for s, e, *_ in gpu)
    ops = {}
    relax_ns = 0
    kernel_ranges = _union(ranges["bench:relax_kernel"])
    for s, e, name, corr, linked in gpu:
        ops[name[:80]] = ops.get(name[:80], 0.0) + (e - s) / 1e9
        launched = runtime.get(corr, cpu_ops.get(linked))
        if launched is not None and _covering(kernel_ranges, launched):
            relax_ns += e - s
    # outermost host operations, sorted and disjoint
    top_ops = []
    for s, e, name in sorted(host_ops):
        if not top_ops or s >= top_ops[-1][1]:
            top_ops.append([s, e, name])
    starts = [o[0] for o in top_ops]
    spans = [(k.split(":")[1], _union(ranges[k]))
             for k in ("bench:transition", "bench:relax_call", "bench:spec")]
    gaps = {}
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    for a, b in zip(edges[::2], edges[1::2]):
        if b <= a:
            continue
        mid = (a + b) / 2
        where = next((n for n, r in spans if _covering(r, mid)),
                     "between specs")
        i = bisect.bisect_right(starts, mid) - 1
        op = top_ops[i][2] if i >= 0 and top_ops[i][1] > mid else "python"
        key = f"{where}: {op}"
        gaps[key] = gaps.get(key, 0.0) + (b - a) / 1e9
    return {"busy_s": sum(e - s for s, e in busy) / 1e9,
            "relax_kernel_s": relax_ns / 1e9 if kernel_ranges else None,
            "device_ops": _top(ops), "idle_gaps": _top(gaps)}

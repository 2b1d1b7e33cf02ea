"""Host spans and counters of the render loop, kept in memory.

One recorder per process, ``RECORDER``, in the port's lowest layer, so
that every layer records into it without importing the viewer.  A span is
a ``with`` block around a layer boundary::

    _PACK = trace.span("crt.pack_tables")

    with _PACK:
        ...

Each span keeps its name, its start and end (``time.perf_counter_ns``),
its id (the order in which spans closed) and its parent's (the span that
was open when it began; -1 for none), the render layer's frame index and
the render layer's id (``new_layer``), and the bytes copied between host
and device inside it, its children's included (``moved``).  A span takes
the frame index and the layer id of the outermost open span, which takes
them from ``Span.at``, else (0, -1).  The newest ``CAPACITY`` spans are
kept in a preallocated ring.  On entry a span pushes its start; on exit
it stores one record, and the nesting is rebuilt when the ring is read,
so the recorder is always on.

While a ``torch.profiler`` records, each span is also entered as a
``torch.profiler.record_function`` range, so that it lies on the device
trace's timeline.  Whether the profiler records is read by
``poll_profiler``, which the render loop calls once a frame (the check
costs about 0.1 us; a ``record_function`` costs about 7 us even with the
profiler off, so it is entered only then).

Counters are named integers (``count``, ``moved``, and ``set`` for a
level such as the latest table build's bytes); the kernels' launch
counters stay the attributes their wrappers keep, and are read through
``register``.  ``summary`` gives spans by name (count, total, mean, p95,
self time and bytes), ``frame_periods_ms`` the time from one
``crt.update`` start to the next, ``export_chrome`` a Chrome-trace JSON
file.  Every span name starts with ``crt.``.  Spans are recorded from one
thread, the render loop's, at most ``MAX_DEPTH`` deep.
"""

from __future__ import annotations

import itertools
import json
import os
from time import perf_counter_ns
from typing import NamedTuple

import numpy as np
import torch

CAPACITY = 1 << 16
MAX_DEPTH = 64
PREFIX = "crt."
_NO_CONTEXT = (0, -1)  # (layer id, frame index) of a span outside any layer


class SpanRecord(NamedTuple):
    """One closed span."""

    id: int  # spans closed before it
    name: str
    start_ns: int
    end_ns: int
    parent: int  # the id of the span open when this one began, or -1
    frame: int  # the render layer's frame index, -1 outside a frame
    layer: int  # the render layer's id, 0 outside any layer
    nbytes: int  # bytes moved between host and device inside it

    @property
    def ms(self) -> float:
        return (self.end_ns - self.start_ns) * 1e-6


class Span:
    """A named span of one recorder.  Reusable and reentrant: the state of
    an open span lives on the recorder's stack."""

    __slots__ = ("name", "_rec", "_stack", "_ring")

    def __init__(self, rec: "Recorder", name: str):
        if not name.startswith(PREFIX):
            raise ValueError(f"span names start with {PREFIX!r}: {name!r}")
        self.name = name
        self._rec = rec
        self._stack = rec._stack
        self._ring = rec._ring

    def at(self, layer: int, frame: int) -> "Span":
        """This span, whose next entry records the render layer ``layer``
        and its frame index ``frame`` if no span is open then (an open
        span's are inherited)."""
        if not self._stack:
            self._rec._context = (layer, frame)
        return self

    def __enter__(self):
        if self._rec.mirror:
            mirror = torch.profiler.record_function(self.name)
            mirror.__enter__()
            self._rec._mirrors.append(mirror)
        self._stack.append(perf_counter_ns())
        return self

    def __exit__(self, exc_type, exc, tb):
        end = perf_counter_ns()
        stack = self._stack
        start = stack.pop()
        rec = self._rec
        if rec.mirror:
            rec._mirrors.pop().__exit__(None, None, None)
        depth = len(stack)
        moved = rec._moved
        nbytes = moved[depth]
        if nbytes:  # the parent's bytes include this span's
            moved[depth] = 0
            if depth:
                moved[depth - 1] += nbytes
        n = rec._closed
        rec._closed = n + 1
        self._ring[n & rec._mask] = (self.name, start, end, depth,
                                     rec._context, nbytes)
        if not depth:
            rec._context = _NO_CONTEXT
        return False


class Recorder:
    """Spans in a ring of ``capacity`` (a power of two) records, and
    counters."""

    __slots__ = ("capacity", "_mask", "_ring", "_closed", "_stack",
                 "_moved", "_mirrors", "_context", "mirror", "counters",
                 "_sources", "_spans", "_layer_ids")

    def __init__(self, capacity: int = CAPACITY):
        if capacity <= 0 or capacity & (capacity - 1):
            raise ValueError(f"capacity must be a power of two: {capacity}")
        self.capacity = capacity
        self._mask = capacity - 1
        self._ring: list = [None] * capacity
        self._closed = 0  # spans closed: the next span's id and ring slot
        self._stack: list = []  # the open spans' starts, innermost last
        self._moved = [0] * (MAX_DEPTH + 1)  # bytes of the open spans
        self._mirrors: list = []  # their record_function ranges
        self._context = _NO_CONTEXT  # the outermost open span's
        self.mirror = False  # enter each span as a record_function range
        self.counters: dict[str, int] = {}
        self._sources: dict[str, tuple] = {}
        self._spans: dict[str, Span] = {}
        self._layer_ids = itertools.count(1)

    # ------------------------------------------------------------ recording
    def span(self, name: str) -> Span:
        """The span named ``name`` (one object per name)."""
        s = self._spans.get(name)
        if s is None:
            s = self._spans[name] = Span(self, name)
        return s

    def new_layer(self) -> int:
        """A fresh render-layer id (1, 2, ...)."""
        return next(self._layer_ids)

    def poll_profiler(self):
        """Mirror the spans into ``torch.profiler`` while it records; read
        only when no span is open, so that a span leaves as it entered."""
        if not self._stack:
            self.mirror = torch.autograd._profiler_enabled()

    def count(self, name: str, n: int = 1):
        self.counters[name] = self.counters.get(name, 0) + n

    def set(self, name: str, value: int | None):
        """The counter ``name`` set to ``value``: a level, not a sum (the
        latest build's).  None removes it."""
        if value is None:
            self.counters.pop(name, None)
        else:
            self.counters[name] = int(value)

    def moved(self, counter: str, nbytes: int):
        """``nbytes`` copied between host and device: added to the counter
        ``counter`` and to the innermost open span's bytes."""
        self.counters[counter] = self.counters.get(counter, 0) + nbytes
        if self._stack:
            self._moved[len(self._stack) - 1] += nbytes

    def open_start_ns(self) -> int:
        """The start of the innermost open span."""
        return self._stack[-1]

    def register(self, name: str, owner, attr: str = "launches"):
        """Read the counter ``name`` from ``owner.<attr>``.  A name's first
        registration holds: an edited copy of a module, executed under
        another name, does not displace the module's own counter."""
        self._sources.setdefault(name, (owner, attr))

    def read_counters(self) -> dict:
        """Every counter: the recorder's own and the registered ones."""
        out = dict(self.counters)
        for name, (owner, attr) in self._sources.items():
            out[name] = int(getattr(owner, attr))
        return out

    def mark(self) -> int:
        """The id the next span to close will get (``since``/``until`` of
        the selections below)."""
        return self._closed

    def clear(self):
        """Drop every span and the recorder's own counters."""
        if self._stack:
            raise RuntimeError("clear() inside an open span")
        self._ring[:] = [None] * self.capacity
        self._closed = 0
        self.counters.clear()

    # ------------------------------------------------------------- reading
    def records(self) -> list[SpanRecord]:
        """The spans in the ring, in the order they closed.  A span's
        parent is the next span one level out to close after it."""
        n = self._closed
        out = []
        waiting: dict = {}  # depth -> closed spans whose parent is open
        for i in range(max(0, n - self.capacity), n):
            name, start, end, depth, (layer, frame), nbytes = \
                self._ring[i & self._mask]
            for k in waiting.pop(depth + 1, ()):
                out[k] = out[k]._replace(parent=i)
            if depth:
                waiting.setdefault(depth, []).append(len(out))
            out.append(SpanRecord(i, name, start, end, -1, frame, layer,
                                  nbytes))
        return out

    def spans(self, name: str | None = None, layer: int | None = None,
              min_frame: int | None = None, since: int | None = None,
              until: int | None = None) -> list[SpanRecord]:
        """The spans in the ring named ``name``, of render layer ``layer``,
        with a frame index of at least ``min_frame`` and an id in
        [``since``, ``until``), each where given; in the order they
        opened."""
        out = [r for r in self.records()
               if (name is None or r.name == name)
               and (layer is None or r.layer == layer)
               and (min_frame is None or r.frame >= min_frame)
               and (since is None or r.id >= since)
               and (until is None or r.id < until)]
        # a parent opens no later and closes no earlier than its child
        return sorted(out, key=lambda r: (r.start_ns, -r.end_ns, -r.id))

    def last_layer(self) -> int | None:
        """The newest render layer with a span in the ring."""
        ids = [r.layer for r in self.records() if r.layer]
        return max(ids) if ids else None

    def summary(self, **select) -> dict:
        """Spans by name over ``spans(**select)``: ``count``, ``total_ms``,
        ``mean_ms``, ``p95_ms``, ``self_ms`` (their durations less the
        parts their child spans cover, summed) and ``bytes`` (moved
        between host and device inside them, summed)."""
        covered: dict = {}  # span id -> ns its children cover
        for r in self.records():
            if r.parent >= 0:
                covered[r.parent] = (covered.get(r.parent, 0)
                                     + r.end_ns - r.start_ns)
        by_name: dict = {}
        for r in self.spans(**select):
            by_name.setdefault(r.name, []).append(r)
        out = {}
        for name, rs in by_name.items():
            ms = np.array([r.ms for r in rs])
            out[name] = {
                "count": len(rs), "total_ms": float(ms.sum()),
                "mean_ms": float(ms.mean()),
                "p95_ms": float(np.percentile(ms, 95)),
                "self_ms": float(ms.sum()) - sum(
                    covered.get(r.id, 0) for r in rs) * 1e-6,
                "bytes": sum(r.nbytes for r in rs)}
        return out

    def frame_periods_ms(self, layer: int, since: int | None = None,
                         until: int | None = None) -> list[float]:
        """The time from each ``crt.update`` start of render layer
        ``layer`` (with an id in [``since``, ``until``)) to the next one's:
        the period of the displayed frames."""
        ups = self.spans("crt.update", layer=layer)
        return [(b.start_ns - a.start_ns) * 1e-6 for a, b in zip(ups, ups[1:])
                if (since is None or a.id >= since)
                and (until is None or a.id < until)]

    def export_chrome(self, path, **select):
        """Write ``spans(**select)`` as complete events (a thread a render
        layer) and the counters as counter events, in the Chrome trace
        format (chrome://tracing, Perfetto)."""
        recs = self.spans(**select)
        pid = os.getpid()
        events = [{"name": r.name, "ph": "X", "ts": r.start_ns * 1e-3,
                   "dur": (r.end_ns - r.start_ns) * 1e-3, "pid": pid,
                   "tid": r.layer, "args": {"id": r.id, "parent": r.parent,
                                            "frame": r.frame,
                                            "bytes": r.nbytes}}
                  for r in recs]
        ts = max((r.end_ns for r in recs), default=perf_counter_ns()) * 1e-3
        events += [{"name": name, "ph": "C", "ts": ts, "pid": pid,
                    "args": {name: value}}
                   for name, value in sorted(self.read_counters().items())]
        with open(path, "w") as f:
            json.dump({"traceEvents": events, "displayTimeUnit": "ms"}, f)


RECORDER = Recorder()


def span(name: str) -> Span:
    """``RECORDER``'s span ``name``."""
    return RECORDER.span(name)


def register(name: str, owner, attr: str = "launches"):
    """``RECORDER.register``."""
    RECORDER.register(name, owner, attr)


def upload(device, *arrays) -> list[torch.Tensor]:
    """The NumPy ``arrays`` as contiguous tensors on ``device``, their
    bytes counted once in ``upload_bytes`` (on the card pageable
    host-to-device copies; on the CPU no copy is made, and the bytes
    count all the same)."""
    out = [torch.from_numpy(np.ascontiguousarray(a)).to(device)
           for a in arrays]
    RECORDER.moved("upload_bytes", sum(t.nbytes for t in out))
    return out

"""The port's one recorder: spans, point marks and counters kept in
memory, the stage timer of the engine's requests and of checkpoint
loading, and device tracing for the command line's ``--profile`` (twin
of qwen3_tts_tpu/utils/profiling.py's ``device_trace``).

- ``span(name, rid=None, **attrs)``: a context manager that records the
  block's start and end on ``time.perf_counter_ns()`` (the clock of the
  batcher's ``_Request.t_*`` stamps), its parent (the thread's innermost
  open span), the request id ``rid``, the thread and ``attrs``.
  ``mark(name, rid)`` records a point, ``record(...)`` a span whose times
  were taken elsewhere (a request's queue wait, which starts on the
  submitting thread).
- Every entry goes into one bounded ring (``RING_SIZE`` entries); the
  oldest are dropped first, and ``dropped`` counts them.
- ``count(name, n)``: cumulative named counters; ``snapshot()`` returns
  them and the dropped-entry count.
- Recording is always on. Only inside ``device_trace`` is every span
  also a ``torch.profiler.record_function`` range, so an operator's
  ``--profile`` trace shows the program's spans; a profiler that anyone
  else starts sees no range from the program. ``to_profiler_ns`` places
  a recorded time on the profiler's clock (Unix-epoch ns).
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import os
import threading
import time
from typing import Dict, List, Optional

import torch

RING_SIZE = 1 << 16


class Span:
    """One ring entry: a span, or a point (``start == end``), in
    perf_counter ns. ``parent`` is the enclosing span's ``id``."""

    __slots__ = ("id", "name", "start", "end", "parent", "rid", "thread",
                 "attrs", "_range")

    def __init__(self, name: str, rid=None, attrs=None):
        self.name, self.rid, self.attrs = name, rid, attrs
        self.id = self.start = self.end = 0
        self.parent = self.thread = self._range = None

    def set(self, **attrs) -> None:
        """Attach attributes to the entry (before it closes)."""
        if self.attrs is None:
            self.attrs = attrs
        else:
            self.attrs.update(attrs)

    @property
    def seconds(self) -> float:
        return (self.end - self.start) / 1e9

    def __enter__(self) -> "Span":
        r = RECORDER
        stack = r._stack()
        self.id = next(r._ids)
        self.parent = stack[-1].id if stack else None
        self.thread = threading.get_ident()
        stack.append(self)
        if r.mirror:
            self._range = torch.profiler.record_function(self.name)
            self._range.__enter__()
        self.start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> None:
        self.end = time.perf_counter_ns()
        r = RECORDER
        if self._range is not None:
            self._range.__exit__(*exc)
            self._range = None
        r._stack().pop()
        r._append(self)


class Recorder:
    """The ring, the counters and the clock anchor of one process."""

    def __init__(self, size: int = RING_SIZE):
        self.ring: "collections.deque[Span]" = collections.deque(maxlen=size)
        self.dropped = 0
        self.counters: Dict[str, int] = {}
        self.mirror = False
        self.anchor_ns = 0
        self._ids = itertools.count(1)
        self._local = threading.local()
        self._lock = threading.Lock()
        self.sample_anchor()

    def sample_anchor(self) -> None:
        """The offset from perf_counter ns to Unix-epoch ns, the clock on
        which the profiler stamps its events."""
        self.anchor_ns = time.time_ns() - time.perf_counter_ns()

    def _stack(self) -> List[Span]:
        st = getattr(self._local, "stack", None)
        if st is None:
            st = self._local.stack = []
        return st

    def _append(self, entry: Span) -> None:
        with self._lock:
            if len(self.ring) == self.ring.maxlen:
                self.dropped += 1
            self.ring.append(entry)


RECORDER = Recorder()


def span(name: str, rid=None, **attrs) -> Span:
    """A context manager recording the block as a span (see the module
    docstring); ``as`` gives the entry, whose ``set`` adds attributes."""
    return Span(name, rid, attrs or None)


def mark(name: str, rid=None, **attrs) -> int:
    """Record a point event now, under the thread's open span; returns
    its perf_counter ns."""
    e = Span(name, rid, attrs or None)
    e.id = next(RECORDER._ids)
    stack = RECORDER._stack()
    e.parent = stack[-1].id if stack else None
    e.thread = threading.get_ident()
    e.start = e.end = time.perf_counter_ns()
    RECORDER._append(e)
    return e.start


def record(name: str, start: int, end: int, rid=None, **attrs) -> Span:
    """Record a span with times taken elsewhere (perf_counter ns), with no
    parent: a request's own spans, which cross threads."""
    e = Span(name, rid, attrs or None)
    e.id = next(RECORDER._ids)
    e.thread = threading.get_ident()
    e.start, e.end = start, end
    RECORDER._append(e)
    return e


def entries(name: Optional[str] = None) -> List[Span]:
    """The ring's entries, oldest first (those named ``name``)."""
    with RECORDER._lock:
        out = list(RECORDER.ring)
    return out if name is None else [e for e in out if e.name == name]


def dropped() -> int:
    return RECORDER.dropped


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the cumulative counter ``name``."""
    r = RECORDER
    with r._lock:
        r.counters[name] = r.counters.get(name, 0) + n


def snapshot() -> dict:
    """The counters and the dropped-entry count."""
    with RECORDER._lock:
        counters = dict(RECORDER.counters)
    return {"counters": counters, "dropped": RECORDER.dropped}


def to_profiler_ns(t_ns: int) -> int:
    """A perf_counter ns time on the profiler's clock (Unix-epoch ns)."""
    return t_ns + RECORDER.anchor_ns


@contextlib.contextmanager
def stage(timings: Dict[str, float], name: str):
    """Records the block as a span and adds its wall seconds to
    timings[name]."""
    sp = Span(name)
    try:
        with sp:
            yield
    finally:
        timings[name] = timings.get(name, 0.0) + sp.seconds


@contextlib.contextmanager
def device_trace(log_dir: Optional[str], device="cuda"):
    """A torch.profiler session around the block, with CUDA activity when
    ``device`` is a GPU, exported as a Chrome trace into ``log_dir``
    (``trace_<pid>.json``); the program's spans are ranges in it, those
    of every thread (a batcher's scheduler thread too). Yields the
    profiler. Does nothing when ``log_dir`` is None."""
    if log_dir is None:
        yield None
        return
    from torch._C._profiler import _ExperimentalConfig
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    try:
        config = _ExperimentalConfig(profile_all_threads=True)
    except TypeError:       # a torch without it traces this thread only
        config = None
    RECORDER.sample_anchor()
    with profile(activities=activities, experimental_config=config) as prof:
        RECORDER.mirror = True
        try:
            yield prof
        finally:
            RECORDER.mirror = False
    prof.export_chrome_trace(os.path.join(log_dir,
                                          f"trace_{os.getpid()}.json"))

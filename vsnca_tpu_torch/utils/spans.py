"""Host-time spans at the port's layer boundaries.

``span(name)`` times its body on the host clock: the body's nanoseconds go
to ``HOST_NS[name]`` and one call to ``CALLS[name]``. It is a context
manager, and a decorator that makes a whole function the span. While a
``torch.profiler`` is recording in the thread, a span also opens the
profiler range ``"vsnca." + name``, which the trace carries as a
``user_annotation``; with no profiler recording it opens none (a range
costs ~13 µs on the host, a span without one under 1 µs). A span adds no
device work and no synchronisation: it times the host's enqueue, not the
device. ``add(name, ns)`` records one call whose time the caller took in
parts. The totals cover the whole process, updated under one lock (the
server steps frames from its request threads).

Span names by layer: the stylizer's ``stylize.*``, the trainers'
``train.*``, the loss terms' ``loss.*``, and the feature nets' ``vgg16``
and ``msoe``.
"""

from __future__ import annotations

import functools
import threading
import time
from collections import defaultdict
from typing import Dict

import torch

HOST_NS: Dict[str, int] = defaultdict(int)  # host ns inside each span, nested spans included
CALLS: Dict[str, int] = defaultdict(int)  # spans closed

PREFIX = "vsnca."  # the profiler range of span "x" is "vsnca.x"

_lock = threading.Lock()
_now = time.perf_counter_ns
_profiling = torch.autograd._profiler_enabled


def add(name: str, ns: int) -> None:
    """One call of span ``name`` that took ``ns`` host nanoseconds, timed by
    the caller: a span whose time is spent in parts between other work (the
    stylizer's chunked upload). It opens no profiler range."""
    with _lock:
        HOST_NS[name] += ns
        CALLS[name] += 1


class span:
    """Span ``name`` (module docstring) around a ``with`` body, or around
    every call of a function it decorates."""

    __slots__ = ("name", "_range", "_t0")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self) -> "span":
        self._range = None
        if _profiling():
            self._range = torch.profiler.record_function(PREFIX + self.name)
            self._range.__enter__()
        self._t0 = _now()
        return self

    def __exit__(self, *exc) -> bool:
        ns = _now() - self._t0
        if self._range is not None:
            self._range.__exit__(*exc)
        add(self.name, ns)
        return False

    def __call__(self, fn):
        name = self.name

        @functools.wraps(fn)
        def spanned(*args, **kwargs):
            with span(name):  # a span of its own each call: calls may nest or overlap
                return fn(*args, **kwargs)

        return spanned

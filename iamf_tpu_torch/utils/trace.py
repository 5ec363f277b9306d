"""Spans and counters: where the host's time goes inside the decoders.

    from iamf_tpu_torch.utils import trace

    with trace.span("plan.put"):     # a named interval of the host's clock
        ...
    trace.count("h2d_bytes", n)      # adds n to a counter

Recording is on while ``IAMF_TRACE=1`` was set when this module was
imported, while ``enable(True)`` holds, or while a ``torch.profiler`` is
active (so a profiled window records its spans with no other switch).
Off, ``span()`` returns one shared no-op object after one test and
``count()`` returns after the same test: nothing is recorded or allocated.

On, a span records its name, its start and end on ``time.perf_counter_ns``
(the clock of ``time.perf_counter``), the thread's ident, its parent (the
span open on the same thread when it began) and its request: the id of its
root, the span that had no span open on its thread when it began, so every
span of one call into the decoders shares it. ``records()`` reads the
spans, ``counters()`` the counters, ``reset()`` clears both. Spans are
kept in memory, up to MAX_RECORDS (a few hundred MB); later ones are
dropped and counted in the counter ``trace.dropped``. Nothing clears them
but ``reset()``: a process that keeps a profiler or IAMF_TRACE on calls it
once it has read them.

A span only reads the host's clock: it never synchronizes or allocates on
the device, never calls ``record_function`` (the profiler would show its
annotation on the device's timeline) and changes no stream order.

The spans of the decoders, by layer:
- front end: ``front.construct`` (root: BatchedStreamDecoder's
  constructor), inside it ``front.parse`` (the OBU parse and database),
  ``front.elements`` (every element's open: codecs, matrices, HRIR banks,
  synthesis constants), ``front.timeline`` (the parameter timeline replay);
- server and host plans: ``plan.build`` (each host plan), ``plan.put``
  (each fill of a call's inputs into their host staging buffer; the
  counter ``h2d_bytes`` adds the bytes it fills), ``plan.copy`` (each
  blocking copy of a staging buffer to the device: it waits for the work
  queued on the device before it, then for the transfer), ``plan.launch``
  (the host's time to issue one decode step), ``plan.sync`` (the wait for
  the device that ends a bucket or a segment);
- serial API: ``serial.decode`` (root: one ``IAMFDecoder.decode`` call),
  inside it ``serial.codec`` (each element's frame decode and demix),
  ``serial.render`` (render, mix gains, mix) and ``serial.limit``
  (limiter, quantize and the copy to the host); the counters
  ``opus.serial_units_pooled`` and ``opus.serial_units_caller`` add one
  for each Opus unit the serial decode runs on the codec's substream pool
  or on the calling thread (codecs/opus/decoder.OpusDecoder.decode);
- mesh: ``mesh.inputs`` (the whole stream's host entropy and unpack of
  ShardedStreamDecoder) and ``mesh.hop`` (each ShardMesh exchange).
"""

from __future__ import annotations

import functools
import itertools
import os
import threading
import time
from typing import NamedTuple

import torch

MAX_RECORDS = 1 << 20


class Span(NamedTuple):
    name: str
    start_ns: int
    end_ns: int
    thread: int
    id: int
    parent: int | None
    request: int


_profiler = torch.autograd.profiler  # its _is_profiler_enabled: a bool
_forced = os.environ.get("IAMF_TRACE") == "1"
_records: list = []
_counters: dict = {}
_lock = threading.Lock()
_ids = itertools.count(1)
_local = threading.local()


class _Off:
    """The span while recording is off: one object, shared."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _On:
    __slots__ = ("name", "id", "parent", "request", "start")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        self.id = next(_ids)
        if stack:
            self.parent = stack[-1].id
            self.request = stack[-1].request
        else:
            self.parent = None
            self.request = self.id
        stack.append(self)
        self.start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        end = time.perf_counter_ns()
        _local.stack.pop()
        rec = Span(self.name, self.start, end, threading.get_ident(), self.id,
                   self.parent, self.request)
        with _lock:
            if len(_records) < MAX_RECORDS:
                _records.append(rec)
            else:
                _counters["trace.dropped"] = _counters.get(
                    "trace.dropped", 0) + 1
        return False


def span(name: str):
    """A context manager that records the named span while recording is
    on."""
    if _forced or _profiler._is_profiler_enabled:
        return _On(name)
    return _OFF


def spanned(name: str):
    """A decorator: each call of the function runs inside span(name)."""

    def wrap(f):
        @functools.wraps(f)
        def traced(*args, **kw):
            with span(name):
                return f(*args, **kw)
        return traced
    return wrap


def count(name: str, n: int) -> None:
    """Add n to the named counter while recording is on."""
    if _forced or _profiler._is_profiler_enabled:
        with _lock:
            _counters[name] = _counters.get(name, 0) + n


def enable(on: bool) -> None:
    """Turn recording on or off (an active torch.profiler still turns it
    on)."""
    global _forced
    _forced = bool(on)


def records() -> list:
    """The recorded spans (Span tuples, in the order they ended), kept."""
    with _lock:
        return list(_records)


def counters() -> dict:
    with _lock:
        return dict(_counters)


def reset() -> None:
    """Clear the spans and the counters."""
    with _lock:
        _records.clear()
        _counters.clear()

"""The program's own tracing: spans, which record only while a torch
profiler runs, and counters, which always count.

A span is declared once, where a module defines it, and opened with
``with``::

    FILL = trace.span('program.dispatch.fill')
    ...
    with FILL:
        ...

While no profiler runs, opening it reads one flag and does nothing else:
no ``record_function``, no clock, no allocation. While one runs, it opens
a ``torch.profiler.record_function`` of its name, so the span sits on the
profiler's timeline beside the device's operations (the profiler also
draws a device-side copy over the work issued in it, which readers of
device time leave out by its ``program.`` name), and it keeps ``(name,
start, end, parent)`` in a ring of the last :data:`STORE_SPANS` spans,
which :func:`summary` reduces to each name's count, total and self time.
Spans are opened on one thread at a time: the parent of a span is the
innermost span open when it opened.

Counters are integer attributes of a module-level owner (a kernel
wrapper, a class), registered as ``(owner, attribute)`` pairs where the
owner is defined and advanced with ``+=``. :data:`COUNTERS` holds the
kernel wrappers' launch counters (``ops/kernel_lib.py`` re-exports it and
its functions); :data:`PROGRAM_COUNTERS` the rest (the graph dispatch's,
distillation's). A CUDA graph's capture launches nothing and each of its
replays launches every kernel it holds: make_train_step_scan
(``parallel/train.py``) takes back whatever its capture counted and adds
that at each replay, so the counters count what the card runs.
"""

import re
import time

import torch

# Span names: the benchmark's reduction of a profiler trace keeps names
# that start with 'program.' on the host side only
NAME = re.compile(r'^program\.[a-z_.]+$')
STORE_SPANS = 65536

_profiler = torch.autograd.profiler
_clock = time.perf_counter_ns


class _Store:
    """The last ``size`` spans since the last :meth:`clear`: name, start
    and end (ns; ``end`` None while open) and the sequence number of the
    parent (-1 for none), a span's slot its sequence number modulo
    ``size``."""

    def __init__(self, size):
        n = self.size = size
        self.names, self.starts = [None] * n, [0] * n
        self.ends, self.parents = [None] * n, [-1] * n
        self.next = 0
        self.clear()

    def clear(self):
        self.first = self.next
        self.open = []  # sequence numbers of the open spans, innermost last

    def begin(self, name, t0):
        seq, i = self.next, self.next % self.size
        self.names[i], self.starts[i], self.ends[i] = name, t0, None
        self.parents[i] = self.open[-1] if self.open else -1
        self.next += 1
        self.open.append(seq)
        return seq

    def end(self, seq, t1):
        if seq in self.open:
            self.open.remove(seq)
        if seq >= max(self.first, self.next - self.size):  # still stored
            self.ends[seq % self.size] = t1

    def closed(self):
        """(sequence number, name, start, end, parent) of each stored span
        that has ended, oldest first."""
        first = max(self.first, self.next - self.size)
        for seq in range(first, self.next):
            i = seq % self.size
            if self.ends[i] is not None:
                yield (seq, self.names[i], self.starts[i], self.ends[i],
                       self.parents[i] if self.parents[i] >= first else -1)


_store = _Store(STORE_SPANS)


class Span:
    """A declared span (see the module's docstring); use :func:`span`."""

    __slots__ = ('name', '_open')

    def __init__(self, name):
        if not NAME.match(name):
            raise ValueError("span name %r: a span's name matches %s"
                             % (name, NAME.pattern))
        self.name = name
        self._open = []

    def __enter__(self):
        if _profiler._is_profiler_enabled:
            rf = _profiler.record_function(self.name)
            rf.__enter__()
            self._open.append((rf, _store.begin(self.name, _clock())))
        return self

    def __exit__(self, *exc):
        if self._open:
            rf, seq = self._open.pop()
            _store.end(seq, _clock())
            rf.__exit__(*exc)


def span(name):
    """Declares the span ``name`` (``program.<a-z_.>``; anything else
    raises); returns it, a context manager."""
    return Span(name)


def spans():
    """(name, start ns, end ns, index of the parent in this list or -1) of
    every stored span that has ended, oldest first."""
    rows = list(_store.closed())
    at = {seq: i for i, (seq, *_) in enumerate(rows)}
    return [(name, t0, t1, at.get(parent, -1))
            for _, name, t0, t1, parent in rows]


def summary():
    """{'spans': {name: {'count', 'total_ms', 'self_ms'}}, 'counters':
    {'<module>.<owner>.<attribute>': value}}: each stored span name's
    count, total duration and self time (its duration less the part its
    child spans cover) in ms, and every registered counter."""
    rows = spans()
    covered = [0] * len(rows)
    for _, t0, t1, parent in rows:
        if parent >= 0:
            covered[parent] += t1 - t0
    by_name = {}
    for (name, t0, t1, _), child in zip(rows, covered):
        s = by_name.setdefault(name, {'count': 0, 'total_ms': 0.0,
                                      'self_ms': 0.0})
        s['count'] += 1
        s['total_ms'] += (t1 - t0) / 1e6
        s['self_ms'] += (t1 - t0 - child) / 1e6
    return {'spans': by_name,
            'counters': {_counter_name(owner, attr): value
                         for (owner, attr), value in counts().items()}}


def reset():
    """Empties the span store (the counters keep counting)."""
    _store.clear()


# ------ counters ------

COUNTERS = []
PROGRAM_COUNTERS = []


def counters(owner, *attrs):
    """Registers ``owner.<attr>`` for each of ``attrs`` as a counter of
    the program, set to 0."""
    for attr in attrs:
        setattr(owner, attr, 0)
        PROGRAM_COUNTERS.append((owner, attr))


def launch_counters(fn, *attrs):
    """Registers ``fn.<attr>`` for each of ``attrs`` as a launch counter,
    set to 0."""
    for attr in attrs:
        setattr(fn, attr, 0)
        COUNTERS.append((fn, attr))


def launch_counts():
    """{(function, attribute): count} of every launch counter."""
    return {(fn, attr): getattr(fn, attr) for fn, attr in COUNTERS}


def counts():
    """{(owner, attribute): count} of every registered counter."""
    return {(owner, attr): getattr(owner, attr)
            for owner, attr in COUNTERS + PROGRAM_COUNTERS}


def add_launches(deltas):
    """Adds each of ``deltas`` ({(owner, attribute): n}) to its counter."""
    for (owner, attr), n in deltas.items():
        setattr(owner, attr, getattr(owner, attr) + n)


def _counter_name(owner, attr):
    return '%s.%s.%s' % (owner.__module__.rsplit('.', 1)[-1],
                         owner.__qualname__, attr)

"""The program's tracer: spans and counters of a mapping run, in memory.

``StageClock(device)`` splits each batch's device work by stage and
synchronises at every stage boundary, so its ``seconds`` are the device
time of each stage; it removes the overlap it measures, so it belongs in
measurement runs only. ``StageClock(device, sync=False)`` never
synchronises: each boundary reads the host clock once, so a run traced
this way keeps its overlap, and its spans say what the host was doing at
every moment.

A span is opened and closed on the thread that runs it (``open`` and
``close``, the run loop's boundaries) or recorded whole by ``mark``,
which closes the stage that ends there and starts the next. Each span
keeps its parent (the span open on its thread when it began), its batch
id ``(pass, batch index)``, which a stage takes from its parent, and on
CUDA the device memory allocated when it ended (a host-side read). Times
are ``time.perf_counter_ns()``; ``anchor`` pairs one such reading with
``time.time_ns()``, so ``to_wall_ns`` puts a span on the Unix-epoch
clock of torch.profiler's events. Appends take a lock: a run may map
from several threads.
"""

from __future__ import annotations

import dataclasses
import threading
import time

import torch


@dataclasses.dataclass
class Span:
    name: str
    start_ns: int
    end_ns: int = 0
    parent: int = -1            # index of the enclosing span, -1 at the top
    batch: tuple | None = None  # (pass, batch index), shared by one batch's spans
    device: str = ""
    memory: int | None = None   # torch.cuda.memory_allocated at its end (CUDA)
    attrs: dict = dataclasses.field(default_factory=dict)


class StageClock:
    """Per-stage seconds of the device work, and the spans and counters of
    the run they were taken in (see the module's docstring)."""

    def __init__(self, device: torch.device | str, sync: bool = True):
        self.device = torch.device(device)
        self.sync = sync
        self.seconds: dict[str, float] = {}
        self.spans: list[Span] = []
        self.counters: dict[str, int] = {}
        self.anchor = (time.perf_counter_ns(), time.time_ns())
        self._lock = threading.Lock()
        self._local = threading.local()

    # ---- the thread's open spans ----
    def _stack(self) -> list[int]:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def _memory(self) -> int | None:
        if self.device.type != "cuda":
            return None
        return torch.cuda.memory_allocated(self.device)

    def _add(self, span: Span) -> int:
        with self._lock:
            self.spans.append(span)
            return len(self.spans) - 1

    def open(self, name: str, batch: tuple | None = None, **attrs) -> int:
        """Open span ``name`` under the thread's innermost open span (whose
        batch id it takes unless given one); the host clock's reading."""
        stack = self._stack()
        parent = stack[-1] if stack else -1
        if batch is None and parent >= 0:
            batch = self.spans[parent].batch
        now = time.perf_counter_ns()
        stack.append(self._add(Span(name, now, parent=parent, batch=batch,
                                    device=str(self.device), attrs=attrs)))
        return now

    def close(self) -> int:
        """Close the thread's innermost open span; the host clock's reading."""
        now = time.perf_counter_ns()
        span = self.spans[self._stack().pop()]
        span.end_ns = now
        span.memory = self._memory()
        return now

    # ---- the stage boundaries inside a batch ----
    def start(self) -> None:
        self._sync()
        self._local.t = time.perf_counter_ns()

    def mark(self, stage: str) -> None:
        """Close the stage that ends here, named ``stage``, and start the
        next."""
        self._sync()
        now = time.perf_counter_ns()
        t = self._local.t
        with self._lock:
            self.seconds[stage] = self.seconds.get(stage, 0.0) + (now - t) * 1e-9
        stack = self._stack()
        parent = stack[-1] if stack else -1
        self._add(Span(stage, t, now, parent=parent,
                       batch=self.spans[parent].batch if parent >= 0 else None,
                       device=str(self.device), memory=self._memory()))
        self._local.t = now

    def _sync(self) -> None:
        if self.sync and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # ---- counters and read-out ----
    def count(self, name: str, n: int) -> None:
        with self._lock:
            self.counters[name] = self.counters.get(name, 0) + n

    def to_wall_ns(self, t_ns: int) -> int:
        """A ``perf_counter_ns`` reading on the ``time.time_ns`` clock."""
        perf0, wall0 = self.anchor
        return t_ns - perf0 + wall0

    def summary(self) -> dict:
        """Per span name: count, total and self seconds (a span's duration
        less what its children cover) and the most memory at its end."""
        children: dict[int, list[tuple[int, int]]] = {}
        for s in self.spans:
            if s.parent >= 0:
                children.setdefault(s.parent, []).append((s.start_ns, s.end_ns))
        out: dict[str, dict] = {}
        for i, s in enumerate(self.spans):
            dur = s.end_ns - s.start_ns
            row = out.setdefault(s.name, {"count": 0, "seconds": 0.0, "self_seconds": 0.0,
                                          "max_memory": None})
            row["count"] += 1
            row["seconds"] += dur * 1e-9
            row["self_seconds"] += (dur - covered(children.get(i, []), s.start_ns,
                                                  s.end_ns)) * 1e-9
            if s.memory is not None:
                row["max_memory"] = max(row["max_memory"] or 0, s.memory)
        return out


def begin(clock: StageClock | None, name: str, **kw) -> int:
    """Open span ``name`` on ``clock`` when there is one; the host clock's
    reading (ns) either way, which the run's timers take."""
    return time.perf_counter_ns() if clock is None else clock.open(name, **kw)


def end(clock: StageClock | None) -> int:
    """Close ``clock``'s innermost span when there is one; the host clock's
    reading (ns) either way."""
    return time.perf_counter_ns() if clock is None else clock.close()


def covered(intervals, lo: int, hi: int) -> int:
    """Nanoseconds of [lo, hi) that the union of ``intervals`` covers."""
    total, cur = 0, lo
    for a, b in sorted(intervals):
        a, b = max(a, cur), min(b, hi)
        if b > a:
            total += b - a
            cur = b
    return total

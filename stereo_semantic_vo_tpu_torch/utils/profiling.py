"""The port's tracer, and ``torch.profiler`` traces.

Port of ``stereo_semantic_vo_tpu.utils.profiling``.  The reference's only
instrumentation is std::chrono around Track plus a median/mean printout at
exit (main.cpp:176-208).  A host timer cannot see a frame here: every frame
is one CUDA graph replay (engine/graphs.py), whose stage code ran on the
host once, at capture.  So the tracer records where the work happens, keeps
it in bounded memory for the whole process, and costs next to nothing when
nobody reads it:

* **Stage stamps** (the Ops and Step layers).  Each step function of an
  ``engine/graphs.StepGraphs`` (init, track, refine) owns a
  :class:`StampRing`, made current around its call by :class:`stamping`.
  Inside the call :class:`stage` writes the time at which a stage begins,
  and the call's end writes one more stamp and advances the ring's counter
  of calls.  On a card a stamp is a one-thread kernel (``csrc/stamp.cu``)
  that writes the card's global nanosecond timer, so a captured graph holds
  its stamps as nodes and every replay writes them with no host work and
  no sync; on the CPU the scope writes ``time.perf_counter_ns()`` into the
  same layout.  A stage runs from its stamp to the next, so the stamps of a
  call tile it.  With no current ring (a step function called directly)
  :class:`stage` does nothing.  A ring holds the newest ``DEPTH`` calls.
* **Program spans** (the Driver and Multi-device layers).  :class:`span`
  records its name, start and end on ``time.perf_counter_ns`` into a
  bounded ring of ``SPANS_KEPT`` records.  Only while a ``torch.profiler``
  listens is a span also a ``record_function`` range, which lands on the
  device trace's clock.
* **Counters**: the CUDA graphs' captures and their milliseconds
  (``core/cuda_graph.Graph``).

:func:`collect` copies all of it to the host (one sync a device) as a
:class:`Trace`, whose methods give the readings a loop iteration; nothing
on the hot path reads it.  A reading ties calls and spans to loop
iterations by their start on the host clock.  :func:`traced` copies the
process's records once for as long as nothing new is recorded, and
:func:`reading` gives one reading of that copy.  :func:`enable` is the
one switch: off before a pipeline or dp tracker is built, its graphs are
captured without stamps, and every span and counter records nothing.  The tracer keeps the newest
``RINGS_KEPT`` rings, past the life of the pipelines that made them.

:func:`device_trace` captures a ``torch.profiler`` trace of the host and
the card (the JAX package's scope captures a ``jax.profiler`` trace for
XProf); the spans appear in it as ranges.
"""

from __future__ import annotations

import collections
import contextlib
import contextvars
import dataclasses
import os
import time

import numpy as np
import torch
import torch.autograd.profiler as _autograd_profiler

DEPTH = 4096       # calls a ring holds: a 51 s window of the sparse step (~3,800 frames)
WIDTH = 8          # stamps a call: the track step's 6 stages and its end
SPANS_KEPT = 1 << 16
RINGS_KEPT = 64
END = "end"        # the name of a call's last stamp


class _Tracer:
    def __init__(self) -> None:
        self.enabled = True
        self.clear()

    def clear(self) -> None:
        self.rings: collections.deque[StampRing] = collections.deque(maxlen=RINGS_KEPT)
        self.spans: collections.deque[tuple] = collections.deque(maxlen=SPANS_KEPT)
        self.captures = 0
        self.capture_ms = 0.0
        self.copied: tuple | None = None  # (what was recorded, its Trace), for reading()


_TRACER = _Tracer()
_CALL: contextvars.ContextVar[_Call | None] = contextvars.ContextVar("ssvo_stamp_call", default=None)


def enable(on: bool = True) -> None:
    """Switch the tracer on or off.  Rings are made, and so graphs
    captured with stamps, only while it is on; spans and counters record
    only while it is on."""
    _TRACER.enabled = bool(on)


def enabled() -> bool:
    return _TRACER.enabled


def clear() -> None:
    """Forget every ring, span and count recorded so far."""
    _TRACER.clear()


class StampRing:
    """The stamps of one step function's calls: ``stamps`` is (DEPTH,
    WIDTH) int64 nanoseconds on ``device``, call c in row c % DEPTH, slot i
    the start of stage ``stages[i]`` and the last used slot its ``END``;
    ``count`` is the device's count of calls ended.  On the host, ``calls``
    counts the calls made and ``host_ns`` holds the host clock when each
    row's call was made."""

    def __init__(self, name: str, device: torch.device | str):
        self.name = name
        self.device = torch.device(device)
        self.stamps = torch.zeros((DEPTH, WIDTH), dtype=torch.int64, device=self.device)
        self.count = torch.zeros((), dtype=torch.int64, device=self.device)
        self.stages: list[str] = []
        self.calls = 0
        self.host_ns = np.zeros(DEPTH, np.int64)
        self._cpu = None if self.device.type == "cuda" else (self.stamps.numpy(), self.count.numpy())

    def called(self) -> None:
        """Note a call on the host, before it is queued."""
        self.host_ns[self.calls % DEPTH] = time.perf_counter_ns()
        self.calls += 1

    def write(self, slot: int, name: str, last: bool) -> None:
        """Stamp stage ``name`` in ``slot`` of the current call's row;
        ``last`` ends the call."""
        if slot < len(self.stages):
            if self.stages[slot] != name:
                raise ValueError(f"{self.name}: stamp {slot} is {name!r}, earlier calls had {self.stages[slot]!r}")
        elif slot >= WIDTH:
            raise ValueError(f"{self.name}: more than {WIDTH} stamps a call")
        else:
            self.stages.append(name)
        if self._cpu is None:
            from stereo_semantic_vo_tpu_torch.kernels import build

            index = self.stamps.get_device()
            build.call_on(index, "ssvo_stamp", self.stamps.data_ptr(), self.count.data_ptr(), DEPTH, WIDTH, slot,
                          int(last), build.stream_handle(self.stamps))
            return
        stamps, count = self._cpu
        stamps[int(count) % DEPTH, slot] = time.perf_counter_ns()
        if last:
            count += 1


def ring(name: str, device: torch.device | str) -> StampRing | None:
    """A new ring kept by the tracer, or None while it is off."""
    if not _TRACER.enabled:
        return None
    r = StampRing(name, device)
    _TRACER.rings.append(r)
    return r


class _Call:
    __slots__ = ("ring", "slot")

    def __init__(self, ring: StampRing):
        self.ring, self.slot = ring, 0

    def stamp(self, name: str, last: bool = False) -> None:
        self.ring.write(self.slot, name, last)
        self.slot += 1


class stamping:
    """Make ``ring`` current around one call of its step function (no-op
    for None); the call's end stamps ``END``.  Under a CUDA graph capture
    the stamps are captured with the call."""

    __slots__ = ("ring", "token")

    def __init__(self, ring: StampRing | None):
        self.ring = ring

    def __enter__(self):
        if self.ring is not None:
            self.token = _CALL.set(_Call(self.ring))
        return self

    def __exit__(self, exc_type, *_):
        if self.ring is not None:
            call = _CALL.get()
            _CALL.reset(self.token)
            if exc_type is None:
                call.stamp(END, last=True)
        return False


class stage:
    """``with stage(name):`` stamps the start of stage ``name`` in the
    current ring; the stage runs until the next stamp of the call."""

    __slots__ = ("name",)

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        call = _CALL.get()
        if call is not None:
            call.stamp(self.name)
        return self

    def __exit__(self, *_):
        return False


class span:
    """``with span(name):`` records one host interval of the program."""

    __slots__ = ("name", "t0", "range")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.t0 = None
        if not _TRACER.enabled:
            return self
        self.range = None
        if _autograd_profiler._is_profiler_enabled:
            self.range = _autograd_profiler.record_function(self.name)
            self.range.__enter__()
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *_):
        if self.t0 is None:
            return False
        t1 = time.perf_counter_ns()
        if self.range is not None:
            self.range.__exit__(None, None, None)
        _TRACER.spans.append((self.name, self.t0, t1))
        return False


def count_capture(ms: float) -> None:
    """Count one CUDA graph capture of ``ms`` milliseconds."""
    if _TRACER.enabled:
        _TRACER.captures += 1
        _TRACER.capture_ms += float(ms)


@dataclasses.dataclass
class RingRecord:
    """A ring on the host: ``stamps`` (n, len(stages)) ns of the newest
    calls, oldest first, with each call's ``host_ns``; ``calls`` counts
    every call the ring's step function made."""

    name: str
    stages: list[str]
    stamps: np.ndarray
    host_ns: np.ndarray
    calls: int


def collect(rings=None) -> Trace:
    """Everything recorded so far, on the host (of the rings, ``rings``
    where given): one sync and one copy a device, a few hundred KB."""
    rings = list(_TRACER.rings if rings is None else rings)
    by_device: dict[torch.device, list[StampRing]] = {}
    for r in rings:
        by_device.setdefault(r.device, []).append(r)
    records = []
    for dev, rs in by_device.items():
        parts = [x for r in rs for x in (r.count.reshape(1), r.stamps[:, :len(r.stages)].reshape(-1))]
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        flat = torch.cat(parts).cpu().numpy()
        at = 0
        for r in rs:
            count, w = int(flat[at]), len(r.stages)
            block = flat[at + 1:at + 1 + DEPTH * w].reshape(DEPTH, w)
            at += 1 + DEPTH * w
            rows = np.arange(max(0, count - DEPTH), count) % DEPTH
            if w == 0 or count == 0:
                continue
            records.append(RingRecord(r.name, list(r.stages), block[rows], r.host_ns[rows], count))
    return Trace(records, list(_TRACER.spans), len(_TRACER.spans) == SPANS_KEPT, _TRACER.captures,
                 _TRACER.capture_ms)


def traced() -> Trace:
    """:func:`collect` over every ring, copied to the host once for as long
    as nothing new is recorded."""
    tr = _TRACER
    mark = (len(tr.spans), tr.spans[-1] if tr.spans else None, tuple((id(r), r.calls) for r in tr.rings),
            tr.captures)
    if tr.copied is None or tr.copied[0] != mark:
        tr.copied = (mark, collect())
    return tr.copied[1]


def reading(intervals_s, before_s: float | None, what: str, *args):
    """``Trace.<what>(its, *args)`` of :func:`traced` for the loop
    iterations ``intervals_s`` that end before ``before_s`` (see
    :func:`iterations`)."""
    return getattr(traced(), what)(iterations(intervals_s, before_s), *args)


def iterations(intervals_s, before_s: float | None = None) -> list[tuple[int, int]]:
    """Loop iterations given as (start, end) seconds on ``time.perf_counter``
    -> (start, end) ns on ``time.perf_counter_ns`` (the same clock), those
    that end before ``before_s`` where given."""
    return [(int(a * 1e9), int(b * 1e9)) for a, b in sorted(intervals_s) if before_s is None or b < before_s]


def _union_ns(intervals) -> int:
    total, end = 0, None
    for a, b in sorted(intervals):
        if end is None or a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total


@dataclasses.dataclass
class Trace:
    """What :func:`collect` copied.  A reading "an iteration" takes the
    loop iterations given as (start, end) ns and counts the calls and spans
    whose host start falls inside one; where the rings or the span ring
    have wrapped, only the iterations they still hold count.  Device
    readings are in ms of the stamps' clock."""

    rings: list[RingRecord]
    spans: list[tuple]  # (name, start ns, end ns)
    spans_wrapped: bool
    captures: int
    capture_ms: float

    def _calls(self, its) -> list[tuple[RingRecord, np.ndarray]]:
        """Each ring with the iteration of each of its calls (-1: none)."""
        starts = np.array([a for a, _ in its], np.int64)
        ends = np.array([b for _, b in its], np.int64)
        out = []
        for r in self.rings:
            k = np.searchsorted(starts, r.host_ns, side="right") - 1
            inside = (k >= 0) & (r.host_ns <= ends[np.clip(k, 0, None)]) if len(its) else k >= 0
            out.append((r, np.where(inside, k, -1)))
        return out

    def _replays(self, its) -> dict[int, list[tuple[int, int]]]:
        """Iteration -> the (first, last) stamps of each of its calls."""
        per: dict[int, list[tuple[int, int]]] = collections.defaultdict(list)
        for r, k in self._calls(its):
            for kk, a, b in zip(k, r.stamps[:, 0], r.stamps[:, -1]):
                if kk >= 0:
                    per[int(kk)].append((int(a), int(b)))
        return per

    def stage_ms(self, its, stage: str) -> float | None:
        """Mean device ms an iteration in ``stage``, from its stamp to the
        next, summed over the iteration's calls; None where no call ran it."""
        calls = self._calls(its)
        held = len(self._replays(its))
        total, seen = 0, False
        for r, k in calls:
            if stage in r.stages[:-1]:
                i = r.stages.index(stage)
                seen = True
                total += int(np.sum((r.stamps[:, i + 1] - r.stamps[:, i])[k >= 0]))
        return total / held / 1e6 if seen and held else None

    def step_ms(self, its) -> float | None:
        """Mean device ms an iteration that its calls cover, each from its
        first stamp to its last: their sum where they ran one after another,
        the union of the streams' where they overlap."""
        per = self._replays(its)
        return float(np.mean([_union_ns(ivs) for ivs in per.values()])) / 1e6 if per else None

    def outside_step_ms(self, its) -> float | None:
        """Mean device ms from an iteration's first stamp to the next
        iteration's, less what its calls cover: the device time of what
        lies between the steps (uploads, copies, readback, idle)."""
        per = self._replays(its)
        first = {k: min(a for a, _ in ivs) for k, ivs in per.items()}
        gaps = [first[k + 1] - first[k] - _union_ns(per[k]) for k in per if k + 1 in per]
        return float(np.mean(gaps)) / 1e6 if gaps else None

    def span_ms(self, its, name: str) -> float | None:
        """Mean host ms an iteration inside spans ``name``."""
        if self.spans_wrapped and self.spans:
            oldest = min(s[1] for s in self.spans)
            its = [(a, b) for a, b in its if a >= oldest]
        if not its:
            return None
        starts = np.array([a for a, _ in its], np.int64)
        total, seen = 0, False
        for n, t0, t1 in self.spans:
            if n != name:
                continue
            k = int(np.searchsorted(starts, t0, side="right")) - 1
            if k >= 0 and t0 <= its[k][1]:
                total += t1 - t0
                seen = True
        return total / len(its) / 1e6 if seen else None

    def stage_ms_per_frame(self, frames: int) -> dict[str, float]:
        """Each stage's mean device ms a frame over ``frames`` frames: its
        mean a call over the calls its rings hold, times their calls in all
        (a ring holds the newest ``DEPTH``)."""
        out: dict[str, float] = collections.defaultdict(float)
        for r in self.rings:
            for i, name in enumerate(r.stages[:-1]):
                out[name] += float(np.mean(r.stamps[:, i + 1] - r.stamps[:, i])) * r.calls / max(frames, 1) / 1e6
        return dict(out)


@contextlib.contextmanager
def device_trace(log_dir: str | None):
    """``torch.profiler`` scope over the host and, where there is one, the
    card; the trace is written under ``log_dir`` as
    ``<host>_<pid>.<ns>.pt.trace.json`` (Chrome trace format, readable by
    TensorBoard's profiler plugin and Perfetto).  A no-op for None."""
    if log_dir is None:
        yield
        return
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(log_dir)):
        yield

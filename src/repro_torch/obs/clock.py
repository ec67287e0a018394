"""The repo's single timing authority.

Every subsystem used to pick its own clock: ``time.time()`` for some
elapsed-time math (wrong — wall clock steps under NTP slew and DST, so a
"duration" can come out negative), ``time.perf_counter()`` elsewhere, and the
virtual clock in testbed runs. This module is the one place that decision is
made, and the ONLY file under ``src/repro/`` allowed to call ``time.time``
(CI greps for violations):

  * ``wall_s()``  — wall-clock epoch seconds, for *timestamps* shown to
    humans or stamped into records (task submitted/finished times, event
    log). Never subtract two of these to get a duration.
  * ``mono_s()``  — monotonic seconds, for *durations*. Meaningless as an
    absolute value; the difference of two is a correct elapsed time even if
    the system clock steps underneath.
  * ``Clock``     — the pluggable source the tracer and testbed use: real
    runs wrap ``mono_s``, virtual runs wrap a ``core.vclock.VirtualClock``
    so traces are functions of the seed alone (byte-identical replays).
"""
from __future__ import annotations

import time
from typing import Callable


def wall_s() -> float:
    """Wall-clock epoch seconds — timestamps only, never duration math."""
    return time.time()


def mono_s() -> float:
    """Monotonic seconds — the only correct basis for elapsed-time math."""
    return time.perf_counter()


class Clock:
    """A named time source: ``now()`` plus a flag for virtual time.

    The tracer records which kind of clock produced a trace so exports can
    say whether their timestamps are replayable (virtual) or one-shot
    (monotonic wall time).
    """

    __slots__ = ("_fn", "virtual")

    def __init__(self, fn: Callable[[], float], *, virtual: bool = False):
        self._fn = fn
        self.virtual = virtual

    def now(self) -> float:
        return self._fn()

    @classmethod
    def monotonic(cls) -> "Clock":
        return cls(mono_s, virtual=False)

    @classmethod
    def of_vclock(cls, vclock) -> "Clock":
        """Wrap a ``core.vclock.VirtualClock`` (reads ``.now``)."""
        return cls(lambda: vclock.now, virtual=True)

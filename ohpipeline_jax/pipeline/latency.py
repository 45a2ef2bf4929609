"""Latency-domain elements: VariableDelay, PhaseAdjuster, StarterTimed,
ClockPuller.

Parity targets: VariableDelay.cpp (insert/remove silence to hit a target
latency for Songcast/Airplay sync; Left/Right variants around the decoded
reservoir, VariableDelay.h:101-134), PhaseAdjuster.cpp (drop/insert audio
at stream start to minimise sender<->receiver phase error,
PhaseAdjuster.h:25-31), StarterTimed.cpp (delay start until an absolute
device time, IAudioTime), ClockPuller.h:9-50 (reservoir-occupancy based
frequency pulling).

Device mapping (SURVEY.md §5.8): rate pulling becomes a fractional resample
ratio at the animator; phase adjustment trims tile offsets.
"""

from __future__ import annotations

import time
from typing import Callable, Optional

import numpy as np

from ..core import events as ev
from ..core.jiffies import Jiffies
from .elements import Element


class VariableDelay(Element):
    """Maintains a target latency by inserting silence (when behind) or
    dropping audio (ramped, when ahead).  DelayEvents set the target
    (MsgDelay; Songcast sets it from the sender's media latency)."""

    def __init__(self, upstream, downstream_latency_jiffies: int = 0,
                 min_delay_jiffies: int = 0, name: str = ""):
        super().__init__(upstream, name)
        self.downstream_latency = downstream_latency_jiffies
        self.min_delay = min_delay_jiffies
        self._target = 0
        self._owed = 0          # positive: owe silence insertions
        self._info = None

    def pull(self) -> ev.Event:
        e = self._next()
        if e.kind == "delay":
            new_target = max(e.remaining - self.downstream_latency,
                             self.min_delay)
            self._owed += new_target - self._target
            self._target = new_target
            return e
        if e.kind == "decoded_stream":
            self._info = e.info
            if self._target:
                self._owed = self._target
            return e
        if isinstance(e, ev.AudioPcmEvent) and self._owed != 0:
            if self._owed > 0:
                silence = ev.SilenceEvent(self._owed, self._info)
                self._owed = 0
                self._defer(e)
                return silence
            # ahead of target: drop audio (whole events up to the debt)
            if e.jiffies <= -self._owed:
                self._owed += e.jiffies
                return self._next() if not self._deferred else \
                    self._deferred.popleft()
            per = e.info.jiffies_per_sample
            drop = (-self._owed // per) * per
            if drop > 0:
                _, right = e.split(drop)
                e = right
            self._owed = 0
        return e


class PhaseAdjuster(Element):
    """Aligns receiver phase to the sender at stream start
    (PhaseAdjuster.h:25-31): compares the sender timestamp of the first
    audio against local playback time and drops/inserts up to a bounded
    span of samples once per stream."""

    MAX_ADJUST = 50 * Jiffies.kPerMs

    def __init__(self, upstream, clock: Callable[[], int] = None, name=""):
        super().__init__(upstream, name)
        self._clock = clock or (lambda: int(time.monotonic()
                                            * Jiffies.kPerSecond))
        self._adjusted = False
        self._error_jiffies = 0
        self._info = None

    def set_phase_error(self, jiffies: int) -> None:
        """Signed error from timestamp comparison (positive: we're late ->
        drop audio; negative: early -> insert silence)."""
        self._error_jiffies = max(-self.MAX_ADJUST,
                                  min(self.MAX_ADJUST, jiffies))
        self._adjusted = False

    def pull(self) -> ev.Event:
        e = self._next()
        if e.kind == "decoded_stream":
            self._info = e.info
            self._adjusted = False
        elif isinstance(e, ev.AudioPcmEvent) and not self._adjusted \
                and self._error_jiffies:
            self._adjusted = True
            err = self._error_jiffies
            if err < 0:
                self._defer(e)
                return ev.SilenceEvent(-err, self._info)
            per = e.info.jiffies_per_sample
            while err >= e.jiffies:
                err -= e.jiffies
                e = self._next()
                if not isinstance(e, ev.AudioPcmEvent):
                    return e
            drop = (err // per) * per
            if 0 < drop < e.jiffies:
                _, e = e.split(drop)
        return e


class StarterTimed(Element):
    """Holds the stream until an absolute device time (StarterTimed.cpp,
    IAudioTime): used for synchronised multi-room starts."""

    def __init__(self, upstream, clock: Callable[[], float] = time.monotonic,
                 name=""):
        super().__init__(upstream, name)
        self._clock = clock
        self._start_at: Optional[float] = None
        self._info = None

    def start_at(self, monotonic_time: float) -> None:
        self._start_at = monotonic_time

    def pull(self) -> ev.Event:
        e = self._next()
        if e.kind == "decoded_stream":
            self._info = e.info
        elif isinstance(e, ev.AudioPcmEvent) and self._start_at is not None:
            now = self._clock()
            if now < self._start_at:
                wait = self._start_at - now
                self._defer(e)
                return ev.SilenceEvent(
                    min(int(wait * Jiffies.kPerSecond),
                        5 * Jiffies.kPerMs), self._info)
            self._start_at = None
        return e


class ClockPuller:
    """Reservoir-occupancy frequency pulling (ClockPuller.h + Utils/
    ClockPullerManual): converges the animator clock multiplier so the
    decoded reservoir holds steady at its target occupancy."""

    def __init__(self, reservoir, animator, target_jiffies: int,
                 gain: float = 1e-9):
        self._reservoir = reservoir
        self._animator = animator
        self.target = target_jiffies
        self.gain = gain
        self.multiplier = 1.0

    def update(self) -> float:
        error = self._reservoir.occupancy - self.target
        self.multiplier = float(np.clip(1.0 + error * self.gain,
                                        0.99, 1.01))
        if hasattr(self._animator, "pull_clock"):
            self._animator.pull_clock(self.multiplier)
        return self.multiplier

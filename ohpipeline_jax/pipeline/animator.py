"""Animators — the render boundary that pulls the pipeline and feeds a DAC
(or a file/test sink).

Parity targets: Media/Utils/AnimatorBasic.cpp (timer-driven DriverThread
pulling at realtime cadence, 77-135) and IPcmProcessor byte delivery
(Msg.h:1204-1278).

Device-batched: the animator is where annotated ramps/gains finally touch
samples.  `RenderBatcher` collects the audio events of one pull quantum
into a (events, channels, samples) tile and executes ONE fused device
program (ops.pcm.apply_gain) for all of them, then packs bytes for the
sink.  Events with unity gain pass through bit-exactly.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Optional

import numpy as np

from ..core import events as ev
from ..core.jiffies import Jiffies
from ..ops import pcm as pcm_ops


class RenderBatcher:
    """Fuses a list of AudioPcmEvents into one device gain dispatch."""

    def __init__(self, use_device: bool = True):
        self.use_device = use_device

    def render(self, events: list[ev.AudioPcmEvent]) -> list[np.ndarray]:
        """Returns per-event (channels, n) int32 arrays, gains applied."""
        if not events:
            return []
        # fast path: all unity -> no math at all
        if all(not e.ramp.enabled and e.attenuation == (1 << 14)
               for e in events):
            return [e.samples for e in events]
        nmax = max(e.num_samples for e in events)
        C = max(e.samples.shape[0] for e in events)
        B = len(events)
        tile = np.zeros((B, C, nmax), np.int32)
        rs = np.ones(B, np.float32)
        re = np.ones(B, np.float32)
        gain = np.ones(B, np.float32)
        for i, e in enumerate(events):
            c, n = e.samples.shape
            tile[i, :c, :n] = e.samples
            if e.ramp.enabled:
                rs[i] = e.ramp.start / (1 << 14)
                re[i] = e.ramp.end / (1 << 14)
            gain[i] = e.attenuation / (1 << 14)
        if self.use_device:
            import jax.numpy as jnp
            out = np.asarray(pcm_ops.apply_gain(
                jnp.asarray(tile), jnp.asarray(rs), jnp.asarray(re),
                jnp.asarray(gain)))
        else:
            t = np.arange(nmax, dtype=np.float32) / nmax
            line = (rs[:, None] + (re - rs)[:, None] * t) * gain[:, None]
            out = np.rint(tile.astype(np.float32)
                          * line[:, None, :]).astype(np.int32)
            unity = (rs == 1.0) & (re == 1.0) & (gain == 1.0)
            out[unity] = tile[unity]
        return [out[i, :e.samples.shape[0], :e.num_samples]
                for i, e in enumerate(events)]


class AnimatorBase:
    """Shared pull-and-render loop machinery."""

    def __init__(self, pipeline, sink: Callable[[np.ndarray, object], None],
                 use_device: bool = True):
        """sink(samples, stream_info) receives rendered (ch, n) arrays."""
        self.pipeline = pipeline
        self.sink = sink
        self.batcher = RenderBatcher(use_device)
        self.info = None
        self._quit = False

    def _handle(self, e: ev.Event, audio_batch: list) -> bool:
        """Returns False when the loop should stop."""
        if isinstance(e, ev.AudioPcmEvent):
            audio_batch.append(e)
        elif isinstance(e, ev.AudioDsdEvent):
            # DSD bypasses the gain batcher (the reference never ramps DSD
            # samples — MuterVolume handles level; IDsdProcessor sink,
            # Msg.h:1204-1278).  Flush queued PCM first to keep ordering.
            self._flush(audio_batch)
            self.sink(e.data, e.info)
        elif e.kind == "silence" and self.info is not None:
            n = e.num_samples(self.info.sample_rate)
            if n > 0:
                audio_batch.append(ev.AudioPcmEvent(
                    np.zeros((self.info.num_channels, n), np.int32),
                    self.info))
        elif e.kind == "decoded_stream":
            self._flush(audio_batch)
            self.info = e.info
        elif e.kind == "drain":
            self._flush(audio_batch)
            e.report_drained()
        elif e.kind == "halt":
            self._flush(audio_batch)
            e.report_halted()
        elif e.kind == "quit":
            self._flush(audio_batch)
            return False
        return True

    def _flush(self, audio_batch: list) -> None:
        if not audio_batch:
            return
        rendered = self.batcher.render(audio_batch)
        for e, samples in zip(audio_batch, rendered):
            self.sink(samples, e.info)
        audio_batch.clear()

    def quit(self):
        self._quit = True


class AnimatorBatch(AnimatorBase):
    """Pulls as fast as possible until QuitEvent/HaltEvent — the batch/bench
    run mode (SURVEY.md §7 'two run modes sharing compiled stages')."""

    def run(self, max_events: Optional[int] = None,
            stop_on_halt: bool = True) -> None:
        batch: list[ev.AudioPcmEvent] = []
        count = 0
        while not self._quit:
            e = self.pipeline.pull()
            count += 1
            if not self._handle(e, batch):
                break
            if e.kind == "halt" and stop_on_halt:
                break
            if len(batch) >= 64:
                self._flush(batch)
            if max_events is not None and count >= max_events:
                break
        self._flush(batch)


class AnimatorBasic(AnimatorBase):
    """Realtime cadenced animator (AnimatorBasic.cpp): a thread pulls
    `quantum_ms` of audio every `quantum_ms`, honouring a pullable clock."""

    def __init__(self, pipeline, sink, quantum_ms: int = 5,
                 use_device: bool = True, realtime: bool = True):
        super().__init__(pipeline, sink, use_device)
        self.quantum_ms = quantum_ms
        self.realtime = realtime
        self._thread: Optional[threading.Thread] = None
        self._clock_multiplier = 1.0   # IPullableClock (ClockPuller.h)

    def pull_clock(self, multiplier: float) -> None:
        """Fractional rate adjustment (reference IPullableClock::PullClock);
        on the device this becomes the resample-ratio knob."""
        self._clock_multiplier = multiplier

    def start(self) -> None:
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="Animator")
        self._thread.start()

    def join(self, timeout=None):
        if self._thread:
            self._thread.join(timeout)

    def _run(self) -> None:
        batch: list[ev.AudioPcmEvent] = []
        next_deadline = time.monotonic()
        quantum_jiffies = self.quantum_ms * Jiffies.kPerMs
        while not self._quit:
            pulled = 0
            while pulled < quantum_jiffies and not self._quit:
                e = self.pipeline.pull()
                if isinstance(e, (ev.AudioPcmEvent, ev.AudioDsdEvent)):
                    pulled += e.jiffies
                elif e.kind == "silence":
                    pulled += e.jiffies
                if not self._handle(e, batch):
                    self._quit = True
                    break
            self._flush(batch)
            if self.realtime:
                period = (self.quantum_ms / 1000.0) / self._clock_multiplier
                next_deadline += period
                delay = next_deadline - time.monotonic()
                if delay > 0:
                    time.sleep(delay)
                else:
                    next_deadline = time.monotonic()


class Silencer:
    """Non-blocking upstream wrapper generating silence while the
    pipeline is halted (Media/Utils/Silencer.cpp): a thread pulls the
    (blocking) pipeline into a bounded queue; pull() hands out queued
    events when available, otherwise — once a stream format is known —
    a SilenceEvent of `silence_jiffies`.  Halt events are swallowed
    (cpp:100-106: "the driver presumably can't do anything with them");
    used by the Songcast driver so receivers keep their clock lock
    across source silence."""

    def __init__(self, upstream, silence_jiffies: int = 5 * Jiffies.kPerMs,
                 max_events: int = 4):
        import queue as _queue
        self._up = upstream
        self._q: "_queue.Queue[ev.Event]" = _queue.Queue(max_events)
        self._silence = silence_jiffies
        self._info = None
        self.halted = True
        self._quit = False
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="Silencer")
        self._thread.start()

    def _run(self) -> None:
        while not self._quit:
            e = self._up.pull()
            self._q.put(e)
            if e.kind == "quit":
                break

    def pull(self) -> ev.Event:
        while True:
            if self._info is None or not self._q.empty():
                e = self._q.get()
                if e.kind == "halt":
                    self.halted = True
                    e.report_halted()
                    continue
                if e.kind == "decoded_stream":
                    self._info = e.info
                elif isinstance(e, ev.AudioPcmEvent):
                    self.halted = False
                elif e.kind == "quit":
                    self._quit = True
                return e
            return ev.SilenceEvent(self._silence, self._info)


class AnimatorSongcastSender(AnimatorBasic):
    """Headless driver rendering the pipeline INTO a Songcast sender
    (Av/Utils/DriverSongcastSender.cpp): pulls 5 ms quanta through a
    Silencer — receivers stay locked across halts because silence keeps
    flowing — and sends every rendered quantum as OHM audio frames with
    running sample positions."""

    def __init__(self, pipeline, ohm_sender, quantum_ms: int = 5,
                 use_device: bool = False, realtime: bool = True):
        self.silencer = Silencer(pipeline)
        self._ohm = ohm_sender
        self._sample_pos = 0
        super().__init__(self.silencer, self._send, quantum_ms=quantum_ms,
                         use_device=use_device, realtime=realtime)

    #: samples per OHM frame — the reference sends 5 ms packets
    #: (Sender.h kSongcastPacketJiffies); also keeps each frame's payload
    #: under the OHM header's 16-bit byte count
    FRAME_SAMPLES = 1024

    def _send(self, samples: np.ndarray, info) -> None:
        halted = self.silencer.halted
        for pos in range(0, samples.shape[1], self.FRAME_SAMPLES):
            chunk = samples[:, pos:pos + self.FRAME_SAMPLES]
            self._ohm.send_audio(chunk, info.sample_rate, info.bit_depth,
                                 sample_start=self._sample_pos,
                                 halt=halted)
            self._sample_pos += chunk.shape[1]

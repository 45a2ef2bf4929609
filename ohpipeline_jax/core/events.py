"""The pipeline's typed event stream — the reference's `Msg` class tree
re-imagined as host-side dataclasses.

Parity target: the 18 message types of OpenHome/Media/Pipeline/Msg.h
(MsgMode:410, MsgTrack:433, MsgDrain:452, MsgDelay:470, MsgEncodedStream:603,
MsgStreamSegment:664, MsgAudioEncoded:681, MsgMetaText:567,
MsgStreamInterrupted:708, MsgHalt:729, MsgFlush:750, MsgWait:765,
MsgDecodedStream:833, MsgAudioPcm:935, MsgAudioDsd:962, MsgSilence:1002,
MsgPlayable:1035, MsgQuit:1163) and double-dispatch via
`Msg::Process(IMsgProcessor&)` (Msg.h:1177-1199).

Design deltas (device-batched):
* No allocator/pool: events are tiny Python objects; bulk audio payload is a
  numpy array (host) destined for batched device tiles, so the zero-alloc
  discipline the reference needs on its audio path lives on the device side
  (fixed-shape compiled programs) instead of a host msg pool.
* `MsgPlayable` has no direct analogue: the renderer boundary consumes
  `AudioPcm`/`AudioDsd`/`Silence` events directly; byte-packing for a DAC is
  a device op (`ops.pcm.pack_output`).
* Dispatch is `event.process(processor)` calling `processor.process_<kind>`;
  a processor returns the (possibly replaced) event, mirroring
  `IMsgProcessor`'s Msg*-returning contract.
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Any, Callable, Optional

import numpy as np

from .jiffies import Jiffies
from .ramp import Ramp
from .streaminfo import (AudioFormat, EncodedStreamInfo, Latency,
                         MultiroomCapability, PcmStreamInfo)

STREAM_ID_INVALID = 0  # IPipelineIdProvider::kStreamIdInvalid


@dataclass(frozen=True, slots=True)
class ModeInfo:
    """Capabilities of a mode (MsgMode's ModeInfo, Msg.h:380-408)."""
    supports_latency: Latency = Latency.NOT_SUPPORTED
    supports_pause: bool = False
    supports_next: bool = False
    supports_prev: bool = False
    supports_repeat: bool = False
    supports_random: bool = False
    ramp_paused: bool = True
    ramp_stopped: bool = True


@dataclass(frozen=True, slots=True)
class Track:
    """Pooled `Track` equivalent (Msg.h:326): uri + DIDL metadata + id."""
    uri: str
    metadata: str = ""
    id: int = 0


class Event:
    """Base event. Subclasses set `kind` and are dispatched by `process`."""

    kind: str = "event"

    def process(self, processor: Any) -> Optional["Event"]:
        """Double dispatch to `processor.process_<kind>(self)`.

        The handler returns the event to pass downstream (commonly `self`),
        a replacement event, or None to consume it.
        """
        return getattr(processor, f"process_{self.kind}")(self)


@dataclass(frozen=True, slots=True)
class ModeEvent(Event):
    """New mode / source selected (MsgMode, Msg.h:410)."""
    mode: str
    info: ModeInfo = field(default_factory=ModeInfo)
    clock_puller: Any = None
    kind = "mode"


@dataclass(frozen=True, slots=True)
class TrackEvent(Event):
    """Start of a new track (MsgTrack, Msg.h:433)."""
    track: Track
    start_of_stream: bool = True
    kind = "track"


@dataclass(slots=True)
class DrainEvent(Event):
    """Request that downstream drains buffers then acks (MsgDrain, Msg.h:452)."""
    callback: Optional[Callable[[], None]] = None
    id: int = 0
    kind = "drain"

    def report_drained(self) -> None:
        if self.callback is not None:
            cb, self.callback = self.callback, None
            cb()


@dataclass(frozen=True, slots=True)
class DelayEvent(Event):
    """Target latency for the stream (MsgDelay, Msg.h:470)."""
    total_jiffies: int
    remaining_jiffies: int = -1   # -1 => same as total
    kind = "delay"

    @property
    def remaining(self) -> int:
        return self.total_jiffies if self.remaining_jiffies < 0 else self.remaining_jiffies


@dataclass(frozen=True, slots=True)
class EncodedStreamEvent(Event):
    """Start of a new encoded stream (MsgEncodedStream, Msg.h:603)."""
    info: EncodedStreamInfo
    stream_handler: Any = None   # IStreamHandler equivalent
    kind = "encoded_stream"


@dataclass(frozen=True, slots=True)
class StreamSegmentEvent(Event):
    """Boundary between segments of a segmented stream, e.g. HLS
    (MsgStreamSegment, Msg.h:664)."""
    segment_id: str
    kind = "stream_segment"


@dataclass(slots=True)
class EncodedAudioEvent(Event):
    """A chunk of encoded bytes (MsgAudioEncoded, Msg.h:681).

    Unlike the reference's fixed 9216-byte cells, chunk size is free — the
    batching boundary that matters on the device is the decoded tile, not the
    encoded cell.
    """
    data: bytes
    kind = "encoded_audio"

    def __len__(self) -> int:
        return len(self.data)


@dataclass(frozen=True, slots=True)
class MetaTextEvent(Event):
    """In-band metadata, e.g. ICY titles (MsgMetaText, Msg.h:567)."""
    text: str
    kind = "metatext"


@dataclass(frozen=True, slots=True)
class StreamInterruptedEvent(Event):
    """Unexpected break in the stream (MsgStreamInterrupted, Msg.h:708)."""
    jiffies: int = 0
    kind = "stream_interrupted"


@dataclass(slots=True)
class HaltEvent(Event):
    """Expected end of delivery; pipeline may go quiet (MsgHalt, Msg.h:729)."""
    id: int = 0
    callback: Optional[Callable[[], None]] = None
    kind = "halt"

    def report_halted(self) -> None:
        if self.callback is not None:
            cb, self.callback = self.callback, None
            cb()


@dataclass(frozen=True, slots=True)
class FlushEvent(Event):
    """Marks the end of discarded data after a seek/skip (MsgFlush, Msg.h:750)."""
    id: int
    kind = "flush"

    ID_INVALID = 0


@dataclass(frozen=True, slots=True)
class WaitEvent(Event):
    """Expected discontinuity; pipeline should wait quietly
    (MsgWait, Msg.h:765)."""
    kind = "wait"


@dataclass(frozen=True, slots=True)
class DecodedStreamEvent(Event):
    """Format announcement for following decoded audio
    (MsgDecodedStream, Msg.h:833)."""
    stream_id: int
    info: PcmStreamInfo
    stream_handler: Any = None
    kind = "decoded_stream"


def _check_pcm_payload(samples: np.ndarray) -> None:
    if samples.ndim != 2:
        raise ValueError("PCM payload must be (channels, samples)")
    if samples.dtype != np.int32:
        raise ValueError("PCM payload must be int32 (native-range)")


@dataclass(slots=True)
class AudioPcmEvent(Event):
    """Decoded PCM audio (MsgAudioPcm, Msg.h:935).

    `samples` is an int32 array of shape (channels, n) holding samples in the
    native range of `info.bit_depth`.  `ramp` is applied by the device DSP
    stage.  `track_offset_jiffies` is the position of the first sample within
    the track.
    """
    samples: np.ndarray
    info: PcmStreamInfo
    track_offset_jiffies: int = 0
    ramp: Ramp = field(default_factory=Ramp.unity)
    attenuation: int = 1 << 14           # kUnityAttenuation (Msg.h:940)
    penultimate: bool = False
    kind = "audio_pcm"

    def __post_init__(self):
        _check_pcm_payload(self.samples)

    @property
    def num_samples(self) -> int:
        return self.samples.shape[1]

    @property
    def jiffies(self) -> int:
        return self.num_samples * self.info.jiffies_per_sample

    def split(self, at_jiffies: int) -> tuple["AudioPcmEvent", "AudioPcmEvent"]:
        """Split at a jiffy offset (MsgAudio::Split, Msg.h:867).

        Offsets that don't land on a sample boundary are rounded down to the
        nearest whole sample (callers like VariableDelay split at arbitrary
        ms positions; the reference rounds via Jiffies::RoundDown).
        """
        per = self.info.jiffies_per_sample
        n = at_jiffies // per
        at_jiffies = n * per
        if not 0 < n < self.num_samples:
            raise ValueError("split position out of range")
        frac = n / self.num_samples
        r1, r2 = self.ramp.split(frac)
        left = AudioPcmEvent(self.samples[:, :n], self.info,
                             self.track_offset_jiffies, r1, self.attenuation)
        right = AudioPcmEvent(self.samples[:, n:], self.info,
                              self.track_offset_jiffies + at_jiffies, r2,
                              self.attenuation, self.penultimate)
        return left, right

    def with_ramp(self, ramp: Ramp) -> "AudioPcmEvent":
        return AudioPcmEvent(self.samples, self.info, self.track_offset_jiffies,
                             self.ramp.compose(ramp), self.attenuation,
                             self.penultimate)


@dataclass(slots=True)
class AudioDsdEvent(Event):
    """DSD audio (MsgAudioDsd, Msg.h:962): packed 1-bit blocks.

    `data` holds packed DSD bytes of shape (channels, nbytes); 8 DSD bits per
    byte, MSB first.  `sample_block_words` mirrors the reference's notion of
    the hardware's DSD block granularity.
    """
    data: np.ndarray
    info: PcmStreamInfo
    track_offset_jiffies: int = 0
    sample_block_words: int = 1
    ramp: Ramp = field(default_factory=Ramp.unity)
    kind = "audio_dsd"

    @property
    def num_samples(self) -> int:
        return self.data.shape[1] * 8

    @property
    def jiffies(self) -> int:
        return self.num_samples * self.info.jiffies_per_sample


@dataclass(frozen=True, slots=True)
class SilenceEvent(Event):
    """A span of silence (MsgSilence, Msg.h:1002)."""
    jiffies: int
    info: PcmStreamInfo | None = None
    kind = "silence"

    def num_samples(self, rate: int) -> int:
        return Jiffies.to_samples(self.jiffies, rate)


@dataclass(frozen=True, slots=True)
class QuitEvent(Event):
    """Pipeline shutdown (MsgQuit, Msg.h:1163)."""
    kind = "quit"


AUDIO_EVENT_TYPES = (AudioPcmEvent, AudioDsdEvent, SilenceEvent)


class EventProcessor:
    """Default pass-through processor (IMsgProcessor, Msg.h:1177).

    Subclass and override the `process_<kind>` hooks of interest; unhandled
    events pass through unchanged.
    """

    def process_default(self, ev: Event) -> Optional[Event]:
        return ev

    def __getattr__(self, name: str):
        if name.startswith("process_"):
            return self.process_default
        raise AttributeError(name)

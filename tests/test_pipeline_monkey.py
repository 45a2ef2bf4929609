"""Randomized control-sequence property test ("monkey") for the
pipeline kernel.

SURVEY.md §7 ("hard parts"): the reference's flush/seek/drain ordering
guarantees must be preserved in the async event model, and its runtime
validators (RampValidator / DecodedAudioValidator, Pipeline.h:23-31)
should be "encoded as property tests".  The targeted semantics tests
pin each transition individually; this test drives the FULL chain with
random interleavings of Play/Pause/Stop/Next/Prev/Seek/Mute while a
cycling multi-track provider keeps content flowing, with every element
wrapped in validators, and asserts the invariants that must hold for
ANY command sequence:

* no validator trips (ramp continuity, audio-after-stream, format
  consistency) and no exception escapes the pull thread;
* the pipeline never wedges: the pull thread always makes progress
  again after a final Play (liveness), and shuts down cleanly;
* decoded audio only flows for streams the IdManager admitted.

The reference exercises this property manually via TestPipeline's
scripted suites (TestPipeline.cpp:27-185); the random driver covers the
interleavings those scripts cannot enumerate.
"""

import threading
import time

import numpy as np
import pytest

from ohpipeline_jax.core import events as ev
from ohpipeline_jax.pipeline import PipelineManager
from ohpipeline_jax.pipeline.filler import UriProvider
from ohpipeline_jax.pipeline.manager import (PipelineInitParams,
                                             SupportElements)


class CyclingProvider(UriProvider):
    """Endless playlist over a fixed track list (next/prev supported)."""

    def __init__(self, uris):
        super().__init__("Monkey", supports_next=True, supports_prev=True)
        self._tracks = [ev.Track(u, "", i + 1) for i, u in enumerate(uris)]
        self._idx = 0

    def begin(self, track_id: int) -> None:
        self._idx = 0

    def get_next(self):
        t = self._tracks[self._idx % len(self._tracks)]
        self._idx += 1
        return t

    def current_track_id(self) -> int:
        return self._tracks[(self._idx - 1) % len(self._tracks)].id

    def move_next(self) -> bool:
        return True          # get_next already advances

    def move_prev(self) -> bool:
        self._idx = max(0, self._idx - 2)
        return True


@pytest.mark.parametrize("seed", [11, 23])
def test_monkey_command_sequences(seed):
    rng = np.random.default_rng(seed)
    params = PipelineInitParams()
    params.gorge_jiffies = 0
    params.threaded_starvation_ramper = False
    params.support_elements = SupportElements.VALIDATOR_FULL
    mgr = PipelineManager(params)
    provider = CyclingProvider([
        "tone://sine.wav?pitch=800&duration=1&samplerate=44100"
        "&bitdepth=16&channels=2",
        "tone://sine.wav?pitch=1200&duration=1&samplerate=44100"
        "&bitdepth=16&channels=2",
        "tone://square.wav?pitch=500&duration=1&samplerate=44100"
        "&bitdepth=16&channels=2",
    ])
    mgr.add_provider(provider)

    errors: list[BaseException] = []
    audio_jiffies = [0]
    seen_streams: list[int] = []
    stop_flag = threading.Event()

    def pump():
        try:
            while not stop_flag.is_set():
                e = mgr.pull()
                if e.kind == "quit":
                    return
                if e.kind == "decoded_stream":
                    seen_streams.append(e.stream_id)
                elif isinstance(e, ev.AudioPcmEvent):
                    audio_jiffies[0] += e.jiffies
                elif e.kind == "halt":
                    e.report_halted()
                elif e.kind == "drain":
                    e.report_drained()
        except BaseException as exc:        # noqa: BLE001 — surfaced below
            if not stop_flag.is_set():
                errors.append(exc)

    t = threading.Thread(target=pump, daemon=True, name="monkey-pump")
    t.start()
    mgr.begin("Monkey")
    mgr.play()

    cmds = ["play", "pause", "stop", "next", "prev", "seek", "mute",
            "unmute", "none"]
    weights = np.array([3, 2, 1, 2, 1, 2, 1, 1, 3], np.float64)
    weights /= weights.sum()
    for _ in range(60):
        cmd = rng.choice(cmds, p=weights)
        try:
            if cmd == "play":
                mgr.play()
            elif cmd == "pause":
                mgr.pause()
            elif cmd == "stop":
                mgr.stop()
            elif cmd == "next":
                mgr.next()
            elif cmd == "prev":
                mgr.prev()
            elif cmd == "seek" and seen_streams:
                mgr.seek(seen_streams[-1], float(rng.random()) * 0.3, 44100)
            elif cmd == "mute":
                mgr.mute()
            elif cmd == "unmute":
                mgr.unmute()
        except BaseException as exc:        # noqa: BLE001
            errors.append(exc)
            break
        time.sleep(float(rng.random()) * 0.01)

    # liveness: whatever state the monkey left behind, Play must flow again
    mgr.unmute()
    mgr.play()
    before = audio_jiffies[0]
    deadline = time.monotonic() + 10.0
    while time.monotonic() < deadline and audio_jiffies[0] == before \
            and not errors:
        mgr.play()                          # cover pause-mid-ramp races
        time.sleep(0.05)
    assert not errors, errors[0]
    assert audio_jiffies[0] > before, "pipeline wedged after final Play"

    stop_flag.set()
    mgr.quit()
    t.join(10.0)
    assert not t.is_alive(), "pull thread failed to shut down"
    assert not errors, errors[0]
    assert seen_streams, "no stream ever started"

"""Tests for the latency/branch element families (VariableDelay,
PhaseAdjuster, StarterTimed, Brancher, SenderThread, AsyncTrackObserver,
SampleReporter) and their presence in the assembled chain."""

import time

import numpy as np

from ohpipeline_jax.core import events as ev
from ohpipeline_jax.core.jiffies import Jiffies
from ohpipeline_jax.core.streaminfo import PcmStreamInfo
from ohpipeline_jax.pipeline import branch, latency

INFO = PcmStreamInfo(44100, 16, 2)


class Up:
    def __init__(self, events):
        self.events = list(events)

    def pull(self):
        return self.events.pop(0) if self.events else ev.QuitEvent()


def audio(n=441, value=100):
    return ev.AudioPcmEvent(np.full((2, n), value, np.int32), INFO)


def stream():
    return ev.DecodedStreamEvent(1, INFO)


class TestVariableDelay:
    def test_inserts_silence_for_target(self):
        target = 100 * Jiffies.kPerMs
        up = Up([stream(), ev.DelayEvent(target), audio(), audio()])
        vd = latency.VariableDelay(up)
        kinds = []
        sil = 0
        for _ in range(6):
            e = vd.pull()
            kinds.append(e.kind)
            if e.kind == "silence":
                sil += e.jiffies
        assert "silence" in kinds
        assert sil == target

    def test_drops_audio_when_ahead(self):
        target = 10 * Jiffies.kPerMs
        up = Up([stream(), ev.DelayEvent(target), audio(4410),
                 ev.DelayEvent(0), audio(4410, value=7)])
        vd = latency.VariableDelay(up)
        total = 0
        while True:
            e = vd.pull()
            if e.kind == "quit":
                break
            if isinstance(e, ev.AudioPcmEvent):
                total += e.num_samples
            elif e.kind == "silence":
                total += e.num_samples(44100)
        # inserted 441 (10ms) then dropped 441 when target dropped to 0
        assert total == 441 + 4410 + 4410 - 441


class TestPhaseAdjuster:
    def test_drop_on_positive_error(self):
        pa = latency.PhaseAdjuster(Up([stream(), audio(441), audio(441)]))
        pa.set_phase_error(5 * Jiffies.kPerMs)   # we're late: drop ~220 smp
        pa.pull()                                # stream
        e = pa.pull()
        assert isinstance(e, ev.AudioPcmEvent)
        assert e.num_samples == 441 - 441 // 2

    def test_insert_on_negative_error(self):
        pa = latency.PhaseAdjuster(Up([stream(), audio(441)]))
        pa.set_phase_error(-5 * Jiffies.kPerMs)
        pa.pull()
        e = pa.pull()
        assert e.kind == "silence"
        assert pa.pull().num_samples == 441


class TestStarterTimed:
    def test_holds_until_time(self):
        t0 = time.monotonic()
        st = latency.StarterTimed(Up([stream(), audio()]),
                                  clock=lambda: time.monotonic())
        st.start_at(t0 + 0.05)
        st.pull()
        saw_silence = False
        while True:
            e = st.pull()
            if e.kind == "silence":
                saw_silence = True
                continue
            break
        assert saw_silence and isinstance(e, ev.AudioPcmEvent)


class TestBrancher:
    def test_tee_clones_audio(self):
        got = []

        class Sink:
            def push(self, e):
                got.append(e.kind)

        b = branch.Brancher(Up([stream(), audio(), audio()]))
        b.attach(Sink())
        kinds = [b.pull().kind for _ in range(3)]
        assert kinds == ["decoded_stream", "audio_pcm", "audio_pcm"]
        assert got == ["decoded_stream", "audio_pcm", "audio_pcm"]

    def test_exclusive_replaces_with_silence(self):
        class Sink:
            def push(self, e):
                pass

        b = branch.Brancher(Up([stream(), audio()]), exclusive=True)
        b.attach(Sink())
        b.pull()
        assert b.pull().kind == "silence"


class TestSenderThread:
    def test_decouples_and_delivers(self):
        got = []
        st = branch.SenderThread(lambda e: got.append(e.kind))
        st.push(audio())
        st.push(ev.HaltEvent())
        deadline = time.time() + 2
        while len(got) < 2 and time.time() < deadline:
            time.sleep(0.01)
        st.quit()
        assert got == ["audio_pcm", "halt"]


class TestAsyncAndSampleReporter:
    def test_async_track_injection(self):
        a = branch.AsyncTrackObserver(Up([audio()]))
        a.track_changed("spotify://x", "<didl/>")
        e = a.pull()
        assert e.kind == "track" and e.track.uri == "spotify://x"
        assert a.pull().kind == "audio_pcm"

    def test_sample_counting(self):
        sr = branch.SampleReporter(Up([stream(), audio(4410), audio(4410)]))
        sr.pull()
        sr.pull()
        sr.pull()
        assert sr.sample_count == 8820
        assert sr.track_position_ms == 200


class Obs:
    """ISpotifyPlaybackObserver recorder."""

    def __init__(self):
        self.calls = []

    def notify_track_length(self, sid, ms):
        self.calls.append(("length", sid, ms))

    def notify_playback_started(self, sid):
        self.calls.append(("started", sid))

    def notify_playback_continued(self, sid):
        self.calls.append(("continued", sid))

    def notify_playback_finished_naturally(self, sid, pos):
        self.calls.append(("finished", sid, pos))


def strack(uri="spotify:42", sos=True):
    return ev.TrackEvent(ev.Track(uri), start_of_stream=sos)


class TestSpotifyReporter:
    """SpotifyReporter position-correction semantics
    (SpotifyReporter.cpp): intercept only on the Spotify mode, swallow
    pipeline MsgDecodedStream and regenerate it with the out-of-band
    start offset + metadata duration, emit a generated MsgTrack with
    DIDL metadata, track playback with subsample counts, and event
    playback started/continued/finished."""

    def test_passthrough_outside_intercept_mode(self):
        sr = branch.SpotifyReporter(Up([ev.ModeEvent("Playlist"),
                                        strack(), stream(), audio()]))
        kinds = [sr.pull().kind for _ in range(4)]
        assert kinds == ["mode", "track", "stream" if False else
                        "decoded_stream", "audio_pcm"]
        assert sr.sub_samples == 0      # no counting off-mode

    def test_stream_regenerated_with_offset_and_duration(self):
        sr = branch.SpotifyReporter(Up([ev.ModeEvent("Spotify"),
                                        strack(), stream(), audio(4410)]))
        sr.metadata_changed({"track": "Song", "artist": "Band",
                             "duration_ms": 60000})
        sr.track_offset_changed(30000)  # track started at 30 s (seek)
        assert sr.pull().kind == "mode"
        assert sr.pull().kind == "track"      # the pipeline track
        gen = sr.pull()                       # generated metadata track
        assert gen.kind == "track" and not gen.start_of_stream
        assert "Song" in gen.track.metadata
        assert "Band" in gen.track.metadata
        st = sr.pull()                        # regenerated stream
        assert st.kind == "decoded_stream"
        assert st.info.sample_start == 30000 * 44100 // 1000
        assert st.info.track_length_jiffies == \
            60 * 44100 * Jiffies.per_sample(44100)
        assert sr.pull().kind == "audio_pcm"
        assert sr.sub_samples == 4410 * 2     # samples x channels

    def test_position_sync_threshold(self):
        sr = branch.SpotifyReporter(Up([ev.ModeEvent("Spotify"),
                                        strack(), stream(), audio(),
                                        audio(), audio()]))
        for _ in range(4):                    # mode, track, gen, stream
            sr.pull()
        assert sr.pull().kind == "audio_pcm"
        sr.track_position(1500)               # < 2000 ms drift: no regen
        assert sr.pull().kind == "audio_pcm"
        sr.track_position(4000)               # > 2000 ms from 1500
        st = sr.pull()
        assert st.kind == "decoded_stream"
        assert st.info.sample_start == 4000 * 44100 // 1000

    def test_flush_suspends_counting_and_continues(self):
        obs = Obs()
        sr = branch.SpotifyReporter(Up([ev.ModeEvent("Spotify"),
                                        strack(), stream(), audio(441),
                                        audio(441), ev.FlushEvent(7),
                                        audio(441)]))
        sr.add_playback_observer(obs)
        for _ in range(4):
            sr.pull()
        sr.pull()                             # audio: started
        assert ("started", 42) in obs.calls
        sr.flush(7)                           # seek: suspend counting
        before = sr.sub_samples
        sr.pull()                             # audio during flush window
        assert sr.sub_samples == before       # not counted
        assert sr.pull().kind == "flush"      # flush id 7 passes
        sr.pull()                             # audio after flush
        assert sr.sub_samples == before + 441 * 2
        assert ("continued", 42) in obs.calls

    def test_finished_naturally_and_track_length(self):
        obs = Obs()
        # the Spotify protocol feeds one continuous stream: subsequent
        # tracks arrive with !StartOfStream (the reference clears its
        # cached stream on StartOfStream tracks and would report pos 0)
        sr = branch.SpotifyReporter(Up([ev.ModeEvent("Spotify"),
                                        strack("spotify:42"), stream(),
                                        audio(44100),
                                        strack("spotify:43", sos=False),
                                        stream(), audio(441)]))
        sr.add_playback_observer(obs)
        for _ in range(4):
            sr.pull()
        sr.pull()                             # 1 s of audio
        nxt = sr.pull()                       # next pipeline track
        assert nxt.kind == "track"
        finished = [c for c in obs.calls if c[0] == "finished"]
        assert finished == [("finished", 42, 1000)]
        for _ in range(3):                    # gen track, stream, audio
            sr.pull()
        assert any(c[0] == "started" and c[1] == 43 for c in obs.calls)
        assert any(c[0] == "length" for c in obs.calls)


class TestAirplayReporter:
    def test_airplay_mode_and_samples(self):
        ar = branch.AirplayReporter(Up([ev.ModeEvent("AirPlay2"),
                                        strack("raop:1"), stream(),
                                        audio(4410)]))
        ar.track_offset_changed(10000)
        assert ar.pull().kind == "mode"
        assert ar.pull().kind == "track"
        gen = ar.pull()
        assert gen.kind == "track" and not gen.start_of_stream
        st = ar.pull()
        assert st.kind == "decoded_stream"
        assert st.info.sample_start == 10000 * 44100 // 1000
        ar.pull()
        assert ar.samples == 4410             # frames, not subsamples


def test_assembled_chain_has_all_elements():
    from ohpipeline_jax.pipeline.manager import Pipeline, PipelineInitParams
    p = PipelineInitParams()
    p.threaded_starvation_ramper = False
    pipe = Pipeline(p)
    for attr in ("ramper", "seeker", "variable_delay_left",
                 "track_inspector", "skipper", "waiter", "stopper",
                 "reporter", "async_track_observer", "sample_reporter",
                 "brancher_songcast", "attenuator", "variable_delay_right",
                 "starvation", "phase_adjuster", "starter_timed", "muter",
                 "volume_ramper", "brancher_bt", "drainer", "predriver"):
        assert hasattr(pipe, attr), attr
    pipe.quit()

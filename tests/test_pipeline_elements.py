"""Per-element unit tests, reference style (SURVEY.md §4.1): each element
is driven by a scripted fake upstream; emitted event order/content/ramps
asserted."""

import numpy as np
import pytest

from ohpipeline_jax.core import events as ev
from ohpipeline_jax.core.jiffies import Jiffies
from ohpipeline_jax.core.ramp import RAMP_MAX, RAMP_MIN
from ohpipeline_jax.core.streaminfo import PcmStreamInfo
from ohpipeline_jax.pipeline import control, elements
from ohpipeline_jax.pipeline.reservoirs import (DecodedAudioReservoir,
                                                EncodedAudioReservoir)

INFO = PcmStreamInfo(44100, 16, 2)


class ScriptedUpstream:
    def __init__(self, events):
        self.events = list(events)

    def pull(self):
        if not self.events:
            return ev.QuitEvent()
        return self.events.pop(0)


def audio(n=441, value=1000, offset=0):
    return ev.AudioPcmEvent(np.full((2, n), value, np.int32), INFO,
                            track_offset_jiffies=offset)


def stream(sample_start=0, live=False):
    return ev.DecodedStreamEvent(1, INFO.with_(sample_start=sample_start,
                                               live=live))


def drain_audio(element, limit=100):
    out = []
    for _ in range(limit):
        e = element.pull()
        out.append(e)
        if e.kind == "quit":
            break
    return out


class TestRamper:
    def test_no_ramp_from_track_start(self):
        up = ScriptedUpstream([stream(0), audio(), audio()])
        r = elements.Ramper(up)
        out = drain_audio(r)
        assert all(not e.ramp.enabled for e in out
                   if isinstance(e, ev.AudioPcmEvent))

    def test_ramp_on_midtrack_join(self):
        up = ScriptedUpstream([stream(44100), audio(44100), audio(441)])
        r = elements.Ramper(up, ramp_jiffies=Jiffies.kPerSecond // 2)
        out = [e for e in drain_audio(r) if isinstance(e, ev.AudioPcmEvent)]
        assert out[0].ramp.enabled
        assert out[0].ramp.start == RAMP_MIN
        # ramp covers exactly 0.5s; the 1s event is split
        total_ramped = sum(e.jiffies for e in out if e.ramp.enabled)
        assert total_ramped == Jiffies.kPerSecond // 2
        assert not out[-1].ramp.enabled


class TestStopper:
    def test_pause_ramps_down_then_blocks(self):
        events = [stream()] + [audio() for _ in range(100)]
        up = ScriptedUpstream(events)
        s = control.Stopper(up, ramp_jiffies=Jiffies.kPerMs * 20)
        assert s.pull().kind == "decoded_stream"
        first = s.pull()
        assert not first.ramp.enabled
        s.pause()
        ramped = []
        e = s.pull()
        while isinstance(e, ev.AudioPcmEvent) and e.ramp.enabled:
            ramped.append(e)
            e = s.pull() if s.state == control.StopperState.RAMPING_DOWN \
                else None
            if e is None:
                break
        assert ramped, "expected ramped audio during pause"
        assert ramped[0].ramp.start == RAMP_MAX
        assert ramped[-1].ramp.end == RAMP_MIN
        assert s.state == control.StopperState.PAUSED
        # play resumes with an up ramp
        s.play()
        e = s.pull()
        assert isinstance(e, ev.AudioPcmEvent) and e.ramp.enabled
        assert e.ramp.start == RAMP_MIN

    def test_stop_emits_halt(self):
        up = ScriptedUpstream([stream()] + [audio() for _ in range(100)])
        s = control.Stopper(up, ramp_jiffies=Jiffies.kPerMs * 10)
        s.pull()
        s.stop()
        kinds = []
        for _ in range(50):
            e = s.pull()
            kinds.append(e.kind)
            if e.kind == "halt":
                break
        assert "halt" in kinds


class TestSkipper:
    def test_skip_ramps_and_flushes_until_next_stream(self):
        up = ScriptedUpstream([stream()] + [audio() for _ in range(20)]
                              + [stream(), audio(value=7)])
        sk = control.Skipper(up, ramp_jiffies=Jiffies.kPerMs * 10)
        assert sk.pull().kind == "decoded_stream"
        sk.remove_current_stream()
        seen_ramp = False
        while True:
            e = sk.pull()
            if isinstance(e, ev.AudioPcmEvent):
                if e.ramp.enabled:
                    seen_ramp = True
                    continue
                # non-ramped audio must be from the new stream
                assert e.samples[0, 0] == 7
                break
            if e.kind == "decoded_stream":
                continue
        assert seen_ramp


class TestWaiter:
    def test_wait_ramps_down_discards_then_ramps_up(self):
        up = ScriptedUpstream(
            [stream(), audio(), ev.WaitEvent()] + [audio() for _ in range(20)]
            + [stream(), audio(value=9)])
        w = control.Waiter(up, ramp_jiffies=Jiffies.kPerMs * 5)
        out = drain_audio(w, limit=40)
        kinds = [e.kind for e in out]
        assert "wait" in kinds
        ramps = [e.ramp.direction.value for e in out
                 if isinstance(e, ev.AudioPcmEvent) and e.ramp.enabled]
        assert "down" in ramps and "up" in ramps


class TestSeeker:
    def test_seek_flow(self):
        flush_id = 42

        def start_seek(sid, sample):
            return flush_id

        up = ScriptedUpstream(
            [stream(), audio(), audio(), audio(),
             ev.FlushEvent(flush_id), stream(sample_start=44100),
             audio(value=5), audio(value=5)])
        s = control.Seeker(up, start_seek, ramp_jiffies=Jiffies.kPerMs * 5)
        assert s.pull().kind == "decoded_stream"
        assert s.seek(1, 44100)
        out = drain_audio(s, limit=30)
        downs = [e for e in out if isinstance(e, ev.AudioPcmEvent)
                 and e.ramp.direction.value == "down"]
        ups = [e for e in out if isinstance(e, ev.AudioPcmEvent)
               and e.ramp.direction.value == "up"]
        assert downs and ups
        # audio between ramp-down completion and flush is discarded
        plain = [e for e in out if isinstance(e, ev.AudioPcmEvent)
                 and not e.ramp.enabled]
        assert all(e.samples[0, 0] == 5 for e in plain)


class TestMuter:
    def test_mute_unmute(self):
        up = ScriptedUpstream([stream()] + [audio() for _ in range(30)])
        m = control.Muter(up, ramp_jiffies=Jiffies.kPerMs * 5)
        m.pull()
        m.mute()
        saw_down = saw_muted = False
        for _ in range(10):
            e = m.pull()
            if isinstance(e, ev.AudioPcmEvent):
                if e.ramp.enabled and e.ramp.direction.value == "down":
                    saw_down = True
                elif m.muted and e.ramp.is_muted:
                    saw_muted = True
                    break
        assert saw_down and saw_muted
        m.unmute()
        e = m.pull()
        assert e.ramp.direction.value == "up"

    def test_unmute_completion_stays_unmuted(self):
        """Once the unmute ramp finishes, audio must flow at unity —
        the completed UP ramp must not re-mute (regression: pull() read
        the ramp direction AFTER apply() cancelled it to NONE, so every
        finished unmute flipped `muted` back on and the pipeline went
        permanently silent; found by the monkey property test)."""
        up = ScriptedUpstream([stream()] + [audio() for _ in range(60)])
        m = control.Muter(up, ramp_jiffies=Jiffies.kPerMs * 5)
        m.pull()
        m.mute()
        for _ in range(40):
            if m.muted:
                break
            m.pull()
        assert m.muted
        m.unmute()
        saw_unity = False
        for _ in range(40):
            e = m.pull()
            if isinstance(e, ev.AudioPcmEvent) and not e.ramp.enabled:
                saw_unity = True
                break
        assert saw_unity, "unmute ramp completion re-muted the pipeline"
        assert not m.muted

    def test_mid_ramp_reversal(self):
        """Unmute during the mute ramp (and vice versa) inverts the
        running ramp from the level already reached (Muter.cpp:75-87,
        110-129) instead of being ignored."""
        up = ScriptedUpstream([stream()] + [audio() for _ in range(60)])
        m = control.Muter(up, ramp_jiffies=Jiffies.kPerMs * 20)
        m.pull()
        m.mute()
        e = m.pull()                        # first ramp-down fragment
        assert e.ramp.direction.value == "down"
        level = e.ramp.end
        m.unmute()                          # cancel mid-mute
        e = m.pull()
        assert e.ramp.direction.value == "up"
        assert e.ramp.start == level        # continues from reached level
        assert not m.muted
        # ride the up ramp out: must end at unity, not muted
        for _ in range(40):
            e = m.pull()
            if isinstance(e, ev.AudioPcmEvent) and not e.ramp.enabled:
                break
        assert not m.muted


class TestAggregator:
    def test_small_chunks_coalesce(self):
        small = [ev.AudioPcmEvent(np.ones((2, 44), np.int32), INFO)
                 for _ in range(20)]
        up = ScriptedUpstream([stream()] + small)
        agg = elements.DecodedAudioAggregator(up)
        agg.pull()  # stream
        e = agg.pull()
        assert isinstance(e, ev.AudioPcmEvent)
        assert e.jiffies >= agg.MAX_JIFFIES or e.num_samples == 44 * 20


class TestValidators:
    def test_ramp_validator_catches_discontinuity(self):
        from ohpipeline_jax.core.ramp import Ramp, RampDirection
        a1 = audio().with_ramp(Ramp(RAMP_MAX, 8000, RampDirection.DOWN, True))
        a2 = audio().with_ramp(Ramp(4000, 0, RampDirection.DOWN, True))
        up = ScriptedUpstream([stream(), a1, a2])
        v = elements.RampValidator(up)
        v.pull()
        v.pull()
        with pytest.raises(AssertionError):
            v.pull()

    def test_decoded_audio_validator_requires_stream(self):
        v = elements.DecodedAudioValidator(ScriptedUpstream([audio()]))
        with pytest.raises(AssertionError):
            v.pull()


class TestReservoirs:
    def test_encoded_backpressure_and_order(self):
        r = EncodedAudioReservoir(capacity_bytes=10)
        r.push(ev.EncodedAudioEvent(b"12345"))
        r.push(ev.EncodedAudioEvent(b"12345"))
        assert r.occupancy == 10
        import threading
        done = threading.Event()

        def producer():
            r.push(ev.EncodedAudioEvent(b"xx"))
            done.set()

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        assert not done.wait(0.1)       # blocked: reservoir full
        assert r.pull().kind == "encoded_audio"
        assert done.wait(1.0)           # unblocked after pull

    def test_decoded_gorging(self):
        r = DecodedAudioReservoir(capacity_jiffies=Jiffies.kPerSecond * 4,
                                  gorge_jiffies=Jiffies.kPerMs * 100)
        r.push(ev.ModeEvent("test"))
        r.push(audio(441))   # 10ms < gorge: pull would block
        assert r._gorging
        for _ in range(10):
            r.push(audio(441))
        assert not r._gorging
        assert r.pull().kind == "mode"


class TestStarvation:
    def test_flywheel_extrapolates_sine(self):
        from ohpipeline_jax.pipeline.starvation import FlywheelRamper
        t = np.arange(4410) / 44100
        hist = np.sin(2 * np.pi * 1000 * t) * 10000
        fw = FlywheelRamper()
        ext = fw.extrapolate(hist, 441)
        ref = np.sin(2 * np.pi * 1000 * (np.arange(4410, 4851) / 44100)) * 10000
        # LPC continuation of a pure sine should track closely at the start
        err = np.abs(ext[:100] - ref[:100]).mean()
        assert err < 500, err

    def test_starvation_emits_flywheel_then_silence(self):
        from ohpipeline_jax.pipeline.starvation import StarvationRamper

        up = ScriptedUpstream([stream(), audio(4410)])

        class BlockingUpstream:
            def __init__(self, inner):
                self.inner = inner

            def pull(self):
                if self.inner.events:
                    return self.inner.pull()
                return None   # emulate starving upstream

        sr = StarvationRamper(BlockingUpstream(up), threaded=False)
        assert sr.pull().kind == "decoded_stream"
        assert isinstance(sr.pull(), ev.AudioPcmEvent)
        e = sr.pull()          # underrun -> flywheel ramp
        assert isinstance(e, ev.AudioPcmEvent)
        assert sr.pull().kind == "stream_interrupted"
        assert sr.pull().kind == "silence"


class TestAttenuator:
    def test_attenuation_annotation(self):
        up = ScriptedUpstream([stream(), audio()])
        att = elements.Attenuator(up)
        att.active = True
        att.set_attenuation(1 << 13)   # -6dB
        att.pull()
        e = att.pull()
        assert e.attenuation == 1 << 13


class TestPreDriver:
    def test_filters_non_animator_events(self):
        up = ScriptedUpstream([ev.ModeEvent("m"), ev.TrackEvent(ev.Track("u")),
                               ev.MetaTextEvent("x"), stream(), audio(),
                               ev.FlushEvent(1), ev.QuitEvent()])
        pd = elements.PreDriver(up)
        kinds = [pd.pull().kind for _ in range(4)]
        assert kinds == ["mode", "decoded_stream", "audio_pcm", "quit"]

"""Core timebase / ramp / event-model tests.

Mirrors the reference's TestMsg.cpp coverage of Jiffies, Ramp and
MsgAudio::Split semantics (SURVEY.md §4.1).
"""

import numpy as np
import pytest

from ohpipeline_jax.core import events
from ohpipeline_jax.core.jiffies import (DSD_RATES, PCM_RATES, PER_SECOND,
                                         Jiffies)
from ohpipeline_jax.core.ramp import (RAMP_MAX, Ramp, RampDirection, set_ramp)
from ohpipeline_jax.core.streaminfo import PcmStreamInfo


class TestJiffies:
    def test_every_rate_divides_timebase(self):
        for rate in PCM_RATES + DSD_RATES:
            assert PER_SECOND % rate == 0, rate
            assert Jiffies.is_valid_sample_rate(rate)

    def test_invalid_rate(self):
        assert not Jiffies.is_valid_sample_rate(44000)
        with pytest.raises(ValueError):
            Jiffies.per_sample(44000)

    def test_round_trip(self):
        j = Jiffies.from_samples(44100, 44100)
        assert j == PER_SECOND
        assert Jiffies.to_samples(j, 44100) == 44100
        assert Jiffies.to_ms(j) == 1000

    def test_rounding(self):
        per = Jiffies.per_sample(48000)
        assert Jiffies.round_down(per * 7 + 3, 48000) == per * 7
        assert Jiffies.round_up(per * 7 + 3, 48000) == per * 8
        assert Jiffies.round_up(per * 7, 48000) == per * 7

    def test_to_bytes(self):
        j = Jiffies.from_ms(5)
        nbytes, rounded = Jiffies.to_bytes(j, 44100, 2, 16)
        # 5ms @44.1k = 220.5 samples -> 220 whole samples
        assert nbytes == 220 * 2 * 2
        assert rounded == 220 * Jiffies.per_sample(44100)

    def test_songcast_time(self):
        assert Jiffies.songcast_ticks_per_second(44100) == 44100 * 256
        assert Jiffies.songcast_ticks_per_second(48000) == 48000 * 256
        assert Jiffies.songcast_ticks_per_second(88200) == 44100 * 256
        j = Jiffies.from_samples(441, 44100)
        assert Jiffies.from_songcast_time(
            Jiffies.to_songcast_time(j, 44100), 44100) == j


class TestRamp:
    def test_unity_and_mute(self):
        u = Ramp.unity()
        assert not u.enabled and u.value_at(0.5) == 1.0
        m = Ramp.muted()
        assert m.is_muted and m.value_at(0.0) == 0.0

    def test_split_interpolates(self):
        r = Ramp(0, RAMP_MAX, RampDirection.UP, True)
        a, b = r.split(0.25)
        assert a.start == 0 and a.end == RAMP_MAX // 4
        assert b.start == RAMP_MAX // 4 and b.end == RAMP_MAX

    def test_compose_selects_lower(self):
        down = Ramp(RAMP_MAX, RAMP_MAX // 2, RampDirection.DOWN, True)
        up = Ramp(0, RAMP_MAX, RampDirection.UP, True)
        c = down.compose(up)
        assert c.start == 0 and c.end == RAMP_MAX // 2

    def test_set_ramp_partial(self):
        r, split = set_ramp(RAMP_MAX, 100, 400, RampDirection.DOWN)
        assert split is None
        assert r.start == RAMP_MAX and r.end == RAMP_MAX - RAMP_MAX // 4

    def test_set_ramp_completes_inside_fragment(self):
        r, split = set_ramp(RAMP_MAX, 500, 400, RampDirection.DOWN)
        assert split == 400
        assert r.end == 0

    def test_median(self):
        r = Ramp(RAMP_MAX, 0, RampDirection.DOWN, True)
        assert r.median_multiplier() == 0.5


def _pcm_event(n=441, channels=2, rate=44100):
    info = PcmStreamInfo(sample_rate=rate, bit_depth=16, num_channels=channels)
    data = np.arange(channels * n, dtype=np.int32).reshape(channels, n)
    return events.AudioPcmEvent(data, info)


class TestEvents:
    def test_audio_split(self):
        ev = _pcm_event(n=441)
        per = ev.info.jiffies_per_sample
        left, right = ev.split(100 * per)
        assert left.num_samples == 100 and right.num_samples == 341
        assert right.track_offset_jiffies == 100 * per
        assert left.jiffies + right.jiffies == ev.jiffies

    def test_audio_split_bad_boundary(self):
        ev = _pcm_event()
        with pytest.raises(ValueError):
            ev.split(ev.info.jiffies_per_sample // 2)

    def test_split_carries_ramp(self):
        ev = _pcm_event(n=400).with_ramp(
            Ramp(RAMP_MAX, 0, RampDirection.DOWN, True))
        left, right = ev.split(200 * ev.info.jiffies_per_sample)
        assert left.ramp.start == RAMP_MAX and left.ramp.end == RAMP_MAX // 2
        assert right.ramp.start == RAMP_MAX // 2 and right.ramp.end == 0

    def test_dispatch(self):
        seen = []

        class Proc(events.EventProcessor):
            def process_audio_pcm(self, ev):
                seen.append("pcm")
                return ev

        ev = _pcm_event()
        out = ev.process(Proc())
        assert out is ev and seen == ["pcm"]
        # unhandled kinds pass through the default
        assert events.QuitEvent().process(Proc()) is not None

    def test_drain_callback_fires_once(self):
        count = []
        ev = events.DrainEvent(callback=lambda: count.append(1))
        ev.report_drained()
        ev.report_drained()
        assert count == [1]

"""HLS/DASH against misbehaving servers (reference TestProtocolHls
pattern, SURVEY.md s4.6): stale live playlists, reload failures,
live-edge drift, broken segments, multi-period MPDs, dynamic MPD
reloads, and DRM gating."""

import pytest

from ohpipeline_jax.protocols import dash as D
from ohpipeline_jax.protocols import hls as H
from ohpipeline_jax.protocols.base import ProtocolStreamResult


class Supply:
    def __init__(self):
        self.events = []

    def output_stream(self, info, stream_handler=None):
        self.events.append(("stream", info))

    def output_data(self, data):
        self.events.append(("data", bytes(data)))

    def output_segment(self, seg):
        self.events.append(("segment", seg))

    def output_stream_interrupted(self):
        self.events.append(("interrupted", None))

    def flush_pending(self):
        pass

    def data(self):
        return b"".join(d for k, d in self.events if k == "data")

    def kinds(self):
        return [k for k, _ in self.events]


def make_hls(responses, **kw):
    def fetch(url):
        v = responses[url]
        return v() if callable(v) else v
    p = H.ProtocolHls(fetch=fetch, sleep=lambda s: None, **kw)
    s = Supply()
    p.initialise(s, None)
    return p, s


LIVE = ("#EXTM3U\n#EXT-X-TARGETDURATION:2\n#EXT-X-MEDIA-SEQUENCE:{seq}\n"
        "{body}")


class TestHlsMisbehaviour:
    def test_stale_live_playlist_gives_up(self):
        text = LIVE.format(seq=5, body="#EXTINF:2,\nseg5.ts\n")
        responses = {"http://h/live.m3u8": text.encode(),
                     "http://h/seg5.ts": b"AAAA"}
        p, s = make_hls(responses)
        res = p.stream("http://h/live.m3u8")
        assert res == ProtocolStreamResult.ERROR_RECOVERABLE
        assert s.data() == b"AAAA"          # delivered what existed

    def test_reload_errors_retried_then_fail(self):
        calls = {"n": 0}

        def playlist():
            calls["n"] += 1
            if calls["n"] == 1:
                return LIVE.format(seq=0,
                                   body="#EXTINF:2,\ns0.ts\n").encode()
            raise OSError("server gone")

        p, s = make_hls({"http://h/l.m3u8": playlist,
                         "http://h/s0.ts": b"x" * 10})
        res = p.stream("http://h/l.m3u8")
        assert res == ProtocolStreamResult.ERROR_RECOVERABLE
        assert calls["n"] == 1 + p.MAX_RELOAD_ERRORS + 1

    def test_live_edge_drift_skips_forward(self):
        calls = {"n": 0}

        def playlist():
            calls["n"] += 1
            if calls["n"] == 1:
                return LIVE.format(seq=0,
                                   body="#EXTINF:2,\ns0.ts\n").encode()
            # the server window jumped from 1 to 50: we fell behind
            return LIVE.format(
                seq=50, body="#EXTINF:2,\ns50.ts\n#EXT-X-ENDLIST\n"
            ).encode()

        p, s = make_hls({"http://h/l.m3u8": playlist,
                         "http://h/s0.ts": b"A", "http://h/s50.ts": b"B"})
        res = p.stream("http://h/l.m3u8")
        assert res == ProtocolStreamResult.SUCCESS
        assert s.data() == b"AB"
        assert "interrupted" in s.kinds()   # drift announced

    def test_broken_segment_skipped_not_spun(self):
        def bad():
            raise OSError("404")
        text = ("#EXTM3U\n#EXT-X-TARGETDURATION:2\n"
                "#EXTINF:2,\na.ts\n#EXTINF:2,\nb.ts\n#EXTINF:2,\nc.ts\n"
                "#EXT-X-ENDLIST\n")
        p, s = make_hls({"http://h/v.m3u8": text.encode(),
                         "http://h/a.ts": b"A", "http://h/b.ts": bad,
                         "http://h/c.ts": b"C"})
        res = p.stream("http://h/v.m3u8")
        assert res == ProtocolStreamResult.SUCCESS
        assert s.data() == b"AC"
        assert "interrupted" in s.kinds()


MPD_MULTI = """<?xml version="1.0"?>
<MPD xmlns="urn:mpeg:dash:schema:mpd:2011" type="static"
     mediaPresentationDuration="PT8S">
  <Period id="p1" duration="PT4S">
    <AdaptationSet mimeType="audio/mp4">
      <SegmentTemplate media="p1-$Number$.m4s" initialization="p1-init.mp4"
          startNumber="1" duration="2" timescale="1"/>
      <Representation id="a" bandwidth="64000"/>
    </AdaptationSet>
  </Period>
  <Period id="p2" duration="PT4S">
    <AdaptationSet mimeType="audio/mp4">
      <SegmentTemplate media="p2-$Number$.m4s" initialization="p2-init.mp4"
          startNumber="1" duration="2" timescale="1"/>
      <Representation id="a" bandwidth="64000"/>
    </AdaptationSet>
  </Period>
</MPD>"""


def make_dash(responses, **kw):
    def fetch(url):
        v = responses[url]
        return v() if callable(v) else v
    p = D.ProtocolDash(fetch=fetch, sleep=lambda s: None, **kw)
    s = Supply()
    p.initialise(s, None)
    return p, s


class TestDashDepth:
    def test_multi_period_plays_in_order(self):
        responses = {"http://h/x.mpd": MPD_MULTI.encode()}
        for pfx in ("p1", "p2"):
            responses[f"http://h/{pfx}-init.mp4"] = f"I{pfx}".encode()
            for n in (1, 2):
                responses[f"http://h/{pfx}-{n}.m4s"] = \
                    f"{pfx}s{n}".encode()
        p, s = make_dash(responses)
        res = p.stream("http://h/x.mpd")
        assert res == ProtocolStreamResult.SUCCESS
        assert s.data() == b"Ip1p1s1p1s2Ip2p2s1p2s2"
        # the period boundary was announced as an expected discontinuity
        assert ("segment", "p2") in s.events

    def test_dynamic_mpd_reload_picks_up_new_segments(self):
        calls = {"n": 0}
        head = ('<?xml version="1.0"?><MPD '
                'xmlns="urn:mpeg:dash:schema:mpd:2011" type="dynamic" '
                'minimumUpdatePeriod="PT1S"><Period>'
                '<AdaptationSet mimeType="audio/mp4"><SegmentTemplate '
                'media="s-$Time$.m4s" timescale="1">'
                '<SegmentTimeline>{tl}</SegmentTimeline>'
                '</SegmentTemplate>'
                '<Representation id="a" bandwidth="1"/>'
                '</AdaptationSet></Period></MPD>')

        def mpd():
            calls["n"] += 1
            if calls["n"] == 1:
                return head.format(tl='<S t="0" d="2"/>').encode()
            if calls["n"] == 2:
                return head.format(
                    tl='<S t="0" d="2"/><S d="2"/>').encode()
            # becomes static: stream ends
            return head.format(
                tl='<S t="0" d="2"/><S d="2"/>').replace(
                    'type="dynamic"', 'type="static"').encode()

        p, s = make_dash({"http://h/live.mpd": mpd,
                          "http://h/s-0.m4s": b"S0",
                          "http://h/s-2.m4s": b"S2"})
        res = p.stream("http://h/live.mpd")
        assert res == ProtocolStreamResult.SUCCESS
        assert s.data() == b"S0S2"

    def test_drm_without_provider_refused(self):
        mpd = MPD_MULTI.replace(
            '<AdaptationSet mimeType="audio/mp4">',
            '<AdaptationSet mimeType="audio/mp4">'
            '<ContentProtection schemeIdUri="urn:uuid:widevine"/>', 1)
        p, s = make_dash({"http://h/x.mpd": mpd.encode()})
        assert p.stream("http://h/x.mpd") == \
            ProtocolStreamResult.ERROR_UNRECOVERABLE
        seen = {}
        p2, _ = make_dash({"http://h/x.mpd": mpd.encode(),
                           **{f"http://h/{x}-init.mp4": b"I"
                              for x in ("p1", "p2")},
                           **{f"http://h/p{i}-{n}.m4s": b"S"
                              for i in (1, 2) for n in (1, 2)}},
                          drm_provider=lambda schemes:
                          seen.setdefault("s", schemes) and True)
        assert p2.stream("http://h/x.mpd") == ProtocolStreamResult.SUCCESS
        assert seen["s"] == ["urn:uuid:widevine"]


class TestIso8601:
    @pytest.mark.parametrize("text,expect", [
        ("PT1H2M3.5S", 3723.5),
        ("P1DT12H", 129600.0),
        ("PT0.5M", 30.0),
        ("P2W", 1209600.0),
        ("P1Y", 365 * 86400.0),
        ("P1M", 30 * 86400.0),
        ("-PT30S", -30.0),
        ("PT", 0.0),
        ("garbage", 0.0),
    ])
    def test_durations(self, text, expect):
        assert D.parse_iso8601_duration(text) == expect

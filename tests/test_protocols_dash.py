"""DASH MPD parsing + streaming tests (reference TestMPEGDash style)."""

import pytest

from ohpipeline_jax.protocols import dash as D
from ohpipeline_jax.protocols.base import ProtocolStreamResult


MPD = """<?xml version="1.0"?>
<MPD xmlns="urn:mpeg:dash:schema:mpd:2011" type="static"
     mediaPresentationDuration="PT10S">
  <Period>
    <AdaptationSet mimeType="audio/mp4" codecs="mp4a.40.2">
      <SegmentTemplate media="$RepresentationID$/seg-$Number%04d$.m4s"
                       initialization="$RepresentationID$/init.mp4"
                       startNumber="1" duration="4" timescale="1"/>
      <Representation id="lo" bandwidth="64000"/>
      <Representation id="hi" bandwidth="128000"/>
    </AdaptationSet>
    <AdaptationSet mimeType="video/mp4">
      <Representation id="v" bandwidth="900000"/>
    </AdaptationSet>
  </Period>
</MPD>"""


class TestMpdParse:
    def test_duration_parsing(self):
        assert D.parse_iso8601_duration("PT10S") == 10.0
        assert D.parse_iso8601_duration("PT1H2M3.5S") == 3723.5
        assert D.parse_iso8601_duration("P1DT1S") == 86401.0
        assert D.parse_iso8601_duration("") == 0.0

    def test_audio_selection_and_template(self):
        mpd = D.parse_mpd(MPD, "http://h/d/manifest.mpd")
        assert mpd.duration == 10.0 and not mpd.is_live
        reps = {r.rep_id for r in mpd.representations}
        assert reps == {"lo", "hi"}          # video set excluded
        best = mpd.best_audio()
        assert best.rep_id == "hi"
        assert best.segment_uri(3) == "http://h/d/hi/seg-0003.m4s"
        assert best.init_url == "hi/init.mp4"
        assert best.segment_duration == 4.0

    def test_segment_timeline(self):
        mpd_text = MPD.replace(
            '<SegmentTemplate media="$RepresentationID$/seg-$Number%04d$.m4s"'
            '\n                       initialization="$RepresentationID$/init.mp4"'
            '\n                       startNumber="1" duration="4" timescale="1"/>',
            '<SegmentTemplate media="$RepresentationID$/$Time$.m4s" '
            'timescale="1000"><SegmentTimeline>'
            '<S t="0" d="4000" r="1"/><S d="2000"/>'
            '</SegmentTimeline></SegmentTemplate>')
        mpd = D.parse_mpd(mpd_text, "http://h/d/m.mpd")
        r = mpd.best_audio()
        assert r.timeline == [(0, 4000, 1), (8000, 2000, 0)]


class CollectingSupply:
    def __init__(self):
        self.data = []
        self.infos = []

    def output_stream(self, info, stream_handler=None):
        self.infos.append(info)

    def output_data(self, d):
        self.data.append(d)

    def output_stream_interrupted(self):
        pass

    def flush_pending(self):
        pass


class TestProtocolDash:
    def test_vod_stream(self):
        responses = {
            "http://h/d/manifest.mpd": MPD.encode(),
            "http://h/d/hi/init.mp4": b"INIT",
            "http://h/d/hi/seg-0001.m4s": b"S1",
            "http://h/d/hi/seg-0002.m4s": b"S2",
            "http://h/d/hi/seg-0003.m4s": b"S3",
        }
        p = D.ProtocolDash(fetch=lambda u: responses[u])
        supply = CollectingSupply()
        p.initialise(supply, None)
        assert p.recognise("dash://h/d/manifest.mpd")
        assert p.stream("dash://h/d/manifest.mpd") \
            is ProtocolStreamResult.SUCCESS
        assert supply.data == [b"INIT", b"S1", b"S2", b"S3"]
        assert supply.infos[0].live is False

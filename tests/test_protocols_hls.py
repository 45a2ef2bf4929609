"""HLS + playlist content-processor tests with scripted fetchers
(reference TestProtocolHls style)."""

import numpy as np
import pytest

from ohpipeline_jax.core import events as ev
from ohpipeline_jax.protocols import hls as HLS
from ohpipeline_jax.protocols import playlists as PL
from ohpipeline_jax.protocols.base import ProtocolStreamResult


class CollectingSupply:
    def __init__(self):
        self.events = []

    def output_stream(self, info, stream_handler=None):
        self.events.append(("stream", info))

    def output_data(self, data):
        self.events.append(("data", data))

    def output_segment(self, seg):
        self.events.append(("segment", seg))

    def output_stream_interrupted(self):
        self.events.append(("interrupted", None))

    def flush_pending(self):
        pass


MASTER = """#EXTM3U
#EXT-X-STREAM-INF:BANDWIDTH=128000,CODECS="mp4a.40.2"
low/index.m3u8
#EXT-X-STREAM-INF:BANDWIDTH=256000,CODECS="mp4a.40.2"
high/index.m3u8
"""

MEDIA_VOD = """#EXTM3U
#EXT-X-TARGETDURATION:4
#EXT-X-MEDIA-SEQUENCE:10
#EXTINF:4.0,
seg10.aac
#EXTINF:4.0,
seg11.aac
#EXT-X-DISCONTINUITY
#EXTINF:2.5,
seg12.aac
#EXT-X-ENDLIST
"""


class TestM3u8Parsing:
    def test_master_sorted_by_bandwidth(self):
        v = HLS.parse_master(MASTER, "http://h/x/master.m3u8")
        assert v[0] == (256000, "http://h/x/high/index.m3u8")
        assert v[1][0] == 128000

    def test_media_fields(self):
        pl = HLS.parse_media(MEDIA_VOD, "http://h/x/index.m3u8")
        assert pl.target_duration == 4.0
        assert pl.media_sequence == 10
        assert pl.ended
        assert [s.sequence for s in pl.segments] == [10, 11, 12]
        assert pl.segments[2].discontinuity
        assert pl.segments[0].uri == "http://h/x/seg10.aac"


class TestProtocolHls:
    def make(self, responses, **kw):
        def fetch(url):
            v = responses[url]
            return v() if callable(v) else v
        return HLS.ProtocolHls(fetch=fetch, sleep=lambda s: None, **kw)

    def test_vod_master_to_segments(self):
        base = "http://h/x"
        responses = {
            f"{base}/master.m3u8": MASTER.encode(),
            f"{base}/high/index.m3u8": MEDIA_VOD.replace(
                "seg", "http://cdn/seg").encode(),
            "http://cdn/seg10.aac": b"AAA",
            "http://cdn/seg11.aac": b"BBB",
            "http://cdn/seg12.aac": b"CCC",
        }
        p = self.make(responses)
        supply = CollectingSupply()
        p.initialise(supply, None)
        assert p.recognise("hls://h/x/master.m3u8")
        res = p.stream("hls://h/x/master.m3u8")
        assert res is ProtocolStreamResult.SUCCESS
        kinds = [k for k, _ in supply.events]
        assert kinds[0] == "stream"
        assert supply.events[0][1].live is False
        datas = [d for k, d in supply.events if k == "data"]
        assert datas == [b"AAA", b"BBB", b"CCC"]
        segs = [d for k, d in supply.events if k == "segment"]
        assert segs == ["12"]

    def test_live_reload_appends_only_new(self):
        base = "http://h/live"
        state = {"n": 0}

        def playlist():
            state["n"] += 1
            segs = "".join(f"#EXTINF:1.0,\nseg{i}.aac\n"
                           for i in range(state["n"] + 1))
            end = "#EXT-X-ENDLIST\n" if state["n"] >= 3 else ""
            return (f"#EXTM3U\n#EXT-X-TARGETDURATION:1\n"
                    f"#EXT-X-MEDIA-SEQUENCE:0\n{segs}{end}").encode()

        responses = {f"{base}/index.m3u8": playlist}
        for i in range(8):
            responses[f"{base}/seg{i}.aac"] = f"S{i}".encode()
        p = self.make(responses, max_reloads=10)
        supply = CollectingSupply()
        p.initialise(supply, None)
        res = p.stream(f"hls://h/live/index.m3u8")
        assert res is ProtocolStreamResult.SUCCESS
        assert supply.events[0][1].live is True
        datas = [d for k, d in supply.events if k == "data"]
        # each segment delivered exactly once, in order
        assert datas == [b"S0", b"S1", b"S2", b"S3"]


class TestPlaylistContent:
    def test_m3u(self):
        text = "#EXTM3U\n# comment\nhttp://a/x.mp3\nrel/y.aac\n"
        assert PL.parse_m3u(text, "http://h/p/l.m3u") == [
            "http://a/x.mp3", "http://h/p/rel/y.aac"]

    def test_pls(self):
        text = "[playlist]\nFile1=http://a/1.mp3\nTitle1=A\nFile2=http://b/2.mp3\n"
        assert PL.parse_pls(text) == ["http://a/1.mp3", "http://b/2.mp3"]

    def test_asx_both_styles(self):
        xml = '<asx version="3.0"><entry><ref href="http://a/s.wma"/></entry></asx>'
        assert PL.parse_asx(xml) == ["http://a/s.wma"]
        old = "[Reference]\nRef1=http://b/s.asf\n"
        assert PL.parse_asx(old) == ["http://b/s.asf"]

    def test_extract_dispatch_and_audio_passthrough(self):
        assert PL.extract_stream_uris(b"[playlist]\nFile1=http://a/1.mp3\n") \
            == ["http://a/1.mp3"]
        assert PL.extract_stream_uris(b"\xff\xfb\x90\x00mp3data") is None
        assert PL.extract_stream_uris(b"fLaC....") is None
        assert PL.extract_stream_uris(
            b"#EXTM3U\nhttp://x/a.mp3\n", content_type="audio/x-mpegurl") \
            == ["http://x/a.mp3"]

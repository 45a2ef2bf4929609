"""Provider-plane depth: the full ProviderTransport / ProviderProduct /
ProviderInfo action tables over ODP (Av/ProviderTransport.cpp,
ProviderProduct.cpp, ProviderInfo.cpp)."""

import json
import time

import numpy as np
import pytest

from ohpipeline_jax.net.odp import OdpClient, OdpError, OdpServer
from ohpipeline_jax.net.providers import make_device


@pytest.fixture
def media_player():
    from ohpipeline_jax.av import MediaPlayer, MediaPlayerInitParams
    from ohpipeline_jax.pipeline.manager import PipelineInitParams
    pp = PipelineInitParams()
    pp.gorge_jiffies = 0
    pp.threaded_starvation_ramper = False
    mp = MediaPlayer(MediaPlayerInitParams(pipeline_params=pp))
    mp.start()
    yield mp
    mp.quit()


@pytest.fixture
def client_server(media_player):
    server = OdpServer()
    server.add_device(make_device(media_player))
    client = OdpClient("127.0.0.1", server.port)
    yield media_player, client
    client.close()
    server.close()


def drain(mp):
    from ohpipeline_jax.pipeline import AnimatorBatch
    chunks = []
    AnimatorBatch(mp.pipeline.pipeline.predriver,
                  lambda s, i: chunks.append(s), use_device=False).run()
    mp.pipeline.flush_observers()
    return np.concatenate(chunks, axis=1) if chunks else None


class TestProductDepth:
    def test_details_and_attributes(self, client_server):
        mp, client = client_server
        man = client.invoke("Product", "Manufacturer")
        assert man["Name"] == "OpenHome"
        model = client.invoke("Product", "Model")
        assert model["Name"] == "ohpipeline-jax"
        prod = client.invoke("Product", "Product")
        assert prod["Room"] == "Main Room"
        attrs = client.invoke("Product", "Attributes")["value"]
        assert "Volume" in attrs and "Info" in attrs
        assert client.invoke("Product",
                             "StandbyTransitioning")["value"] is False

    def test_source_action_and_change_count(self, client_server):
        mp, client = client_server
        src0 = client.invoke("Product", "Source", index=0)
        assert src0["SystemName"] == "Playlist"
        assert src0["Type"] == "Playlist"
        assert src0["Visible"] is True
        with pytest.raises(OdpError) as e:
            client.invoke("Product", "Source", index=77)
        assert e.value.code == 801
        with pytest.raises(OdpError) as e:
            client.invoke("Product", "SetSourceIndex", value=77)
        assert e.value.code == 801
        count0 = client.invoke("Product", "SourceXmlChangeCount")["value"]
        # renaming a source bumps the change count (Source config
        # subscription -> Product::SourceXmlChanged)
        mp.config.get("Source.Radio.Name").set("FM")
        count1 = client.invoke("Product", "SourceXmlChangeCount")["value"]
        assert count1 == count0 + 1
        assert "<Name>FM</Name>" in \
            client.invoke("Product", "SourceXml")["value"]

    def test_select_by_system_name(self, client_server):
        mp, client = client_server
        client.invoke("Product", "SetSourceBySystemName", value="Radio")
        assert client.invoke("Product", "SourceIndex")["value"] == 1
        with pytest.raises(OdpError) as e:
            client.invoke("Product", "SetSourceBySystemName",
                          value="NoSuch")
        assert e.value.code == 801


class TestTransportDepth:
    def test_modes_and_state_queries(self, client_server):
        mp, client = client_server
        modes = json.loads(client.invoke("Transport", "Modes")["value"])
        assert "Playlist" in modes and "Radio" in modes
        assert client.invoke("Transport",
                             "TransportState")["value"] in (
            "Stopped", "Buffering", "Playing", "Paused", "Waiting")
        info = client.invoke("Transport", "ModeInfo")
        assert set(info) == {"CanSkipNext", "CanSkipPrevious",
                             "CanRepeat", "CanShuffle"}
        sinfo = client.invoke("Transport", "StreamInfo")
        assert set(sinfo) == {"StreamId", "CanSeek", "CanPause"}

    def test_repeat_shuffle_shared_state(self, client_server):
        mp, client = client_server
        assert client.invoke("Transport", "Repeat")["value"] is False
        client.invoke("Transport", "SetRepeat", value=True)
        client.invoke("Transport", "SetShuffle", value=True)
        assert client.invoke("Transport", "Repeat")["value"] is True
        assert client.invoke("Transport", "Shuffle")["value"] is True
        # the shared TransportRepeatRandom reached the playlist provider
        assert mp.source_playlist.provider.repeat is True

    def test_seek_errors_and_success(self, client_server):
        mp, client = client_server
        # no current stream -> 804 stream id not current
        with pytest.raises(OdpError) as e:
            client.invoke("Transport", "SeekSecondAbsolute", streamId=1,
                          secondAbsolute=2)
        assert e.value.code == 804
        # play a seekable 3s tone, drain, then the stream id is known
        client.invoke("Transport", "PlayUri",
                      uri="tone://sine.wav?pitch=500&duration=3")
        drain(mp)
        sid = client.invoke("Transport", "StreamId")["value"]
        assert sid != 0
        with pytest.raises(OdpError) as e:
            client.invoke("Transport", "SeekSecondAbsolute",
                          streamId=sid + 7, secondAbsolute=1)
        assert e.value.code == 804

    def test_play_as(self, client_server):
        mp, client = client_server
        with pytest.raises(OdpError) as e:
            client.invoke("Transport", "PlayAs", mode="NoSuchMode")
        assert e.value.code == 801
        cmd = "track=" + json.dumps(
            {"uri": "tone://sine.wav?pitch=500&duration=1"})
        client.invoke("Transport", "PlayAs", mode="Playlist", command=cmd)
        pcm = drain(mp)
        assert pcm is not None and pcm.shape[1] == 44100


class TestInfoDepth:
    def test_counters_track_details_metatext(self, client_server):
        mp, client = client_server
        c0 = client.invoke("Info", "Counters")
        assert c0 == {"TrackCount": 0, "DetailsCount": 0,
                      "MetatextCount": 0}
        client.invoke("Transport", "PlayUri",
                      uri="tone://sine.wav?pitch=500&duration=1")
        drain(mp)
        c1 = client.invoke("Info", "Counters")
        assert c1["TrackCount"] >= 1 and c1["DetailsCount"] >= 1
        track = client.invoke("Info", "Track")
        assert track["Uri"].startswith("tone://")
        det = client.invoke("Info", "Details")
        assert det["SampleRate"] == 44100
        assert det["BitDepth"] == 16
        assert det["Duration"] == 1
        assert det["CodecName"]
        assert client.invoke("Info", "Metatext")["value"] == ""


class TestPlaylistDepth:
    def test_full_table(self, client_server):
        mp, client = client_server
        assert client.invoke("Playlist", "TracksMax")["value"] == 1000
        pinfo = client.invoke("Playlist", "ProtocolInfo")["value"]
        assert "HTTP:*:*:*" in pinfo and "HLS:*:*:*" in pinfo
        i1 = client.invoke("Playlist", "Insert", afterId=0,
                           uri="http://a/1.flac", metadata="<m1/>")["newId"]
        i2 = client.invoke("Playlist", "Insert", afterId=i1,
                           uri="http://a/2&x.flac")["newId"]
        arr = client.invoke("Playlist", "IdArray")
        assert arr["array"] == [i1, i2]
        token = arr["token"]
        assert client.invoke("Playlist", "IdArrayChanged",
                             token=token)["value"] is False
        assert client.invoke("Playlist", "IdArrayChanged",
                             token=token + 5)["value"] is True
        # ReadList XML with escaping; bad/unknown ids skipped
        xml = client.invoke("Playlist", "ReadList",
                            idList=f"{i2} 999 bogus")["value"]
        assert xml.startswith("<TrackList>")
        assert "http://a/2&amp;x.flac" in xml and "999" not in xml
        with pytest.raises(OdpError) as e:
            client.invoke("Playlist", "Read", id=999)
        assert e.value.code == 800
        with pytest.raises(OdpError) as e:
            client.invoke("Playlist", "Insert", afterId=777, uri="u://x")
        assert e.value.code == 800
        with pytest.raises(OdpError) as e:
            client.invoke("Playlist", "SeekIndex", value=50)
        assert e.value.code == 802
        assert client.invoke("Playlist",
                             "TransportState")["value"] == "Stopped"

    def test_playlist_full_801(self, client_server):
        mp, client = client_server
        mp.source_playlist.db.max_tracks = 1
        client.invoke("Playlist", "Insert", afterId=0, uri="u://1")
        with pytest.raises(OdpError) as e:
            client.invoke("Playlist", "Insert", afterId=0, uri="u://2")
        assert e.value.code == 801


class TestRadioDepth:
    def test_full_table(self, client_server):
        mp, client = client_server
        assert client.invoke("Radio", "ChannelsMax")["value"] == 100
        client.invoke("Radio", "SetPreset", index=0,
                      uri="http://radio/one", metadata="<r1/>")
        client.invoke("Radio", "SetPreset", index=2,
                      uri="http://radio/three")
        arr = client.invoke("Radio", "IdArray")
        assert arr["array"][0] == 1 and arr["array"][2] == 3
        assert client.invoke("Radio", "IdArrayChanged",
                             token=arr["token"])["value"] is False
        # select by preset id
        client.invoke("Radio", "SetId", value=1)
        assert client.invoke("Radio", "Id")["value"] == 1
        assert client.invoke("Radio", "Read", id=1)["metadata"] == "<r1/>"
        with pytest.raises(OdpError) as e:
            client.invoke("Radio", "SetId", value=42)
        assert e.value.code == 800
        # directly-tuned channel clears the preset id
        client.invoke("Radio", "SetChannel", uri="http://radio/direct")
        ch = client.invoke("Radio", "Channel")
        assert ch["uri"] == "http://radio/direct"
        assert client.invoke("Radio", "Id")["value"] == 0
        xml = client.invoke("Radio", "ReadList", idList="1 3 77")["value"]
        assert "<Entry><Id>1</Id>" in xml and "77" not in xml


class TestProductAttributes:
    def test_providers_register_attributes(self, client_server):
        """Each provider adds its name to the attribute string
        (Product::AddAttribute, MediaPlayer.cpp:222-253)."""
        mp, client = client_server
        attrs = client.invoke("Product", "Attributes")["value"].split()
        for name in ("Info", "Time", "Volume", "Credentials", "OAuth",
                     "Transport", "Playlist", "Radio", "Config",
                     "Reaction", "Debug", "Pins"):
            assert name in attrs, (name, attrs)

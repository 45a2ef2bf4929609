"""Network-plane tests on loopback (reference style §4.6: multiroom and
control planes exercised in one process): OHM codec + sender/receiver with
loss repair, SCD over TCP, ODP control of a full MediaPlayer."""

import time

import numpy as np
import pytest

from ohpipeline_jax.net import songcast as sc
from ohpipeline_jax.net import scd as scd_mod
from ohpipeline_jax.net.odp import OdpClient, OdpServer
from ohpipeline_jax.net.providers import make_device


class TestOhmWire:
    def test_audio_roundtrip(self):
        pcm = np.arange(-400, 400, dtype=np.int32).reshape(2, -1)
        from ohpipeline_jax.ops.pcm import pack_pcm_bytes
        msg = sc.OhmAudio(frame=7, sample_start=1000, samples_total=44100,
                          sample_rate=44100, bit_depth=24, channels=2,
                          payload=pack_pcm_bytes(pcm, 24, big_endian=True),
                          media_latency=123)
        wire = msg.encode()
        t, size = sc.parse_header(wire)
        assert t == sc.MSG_AUDIO and size == len(wire) - 8
        back = sc.OhmAudio.decode(wire[8:])
        assert back.frame == 7 and back.sample_rate == 44100
        assert back.media_latency == 123 and back.bit_depth == 24
        from ohpipeline_jax.ops.pcm import unpack_pcm_bytes
        np.testing.assert_array_equal(
            unpack_pcm_bytes(back.payload, 24, 2, big_endian=True), pcm)

    def test_track_metatext_resend(self):
        w = sc.encode_track(3, b"http://u", b"<didl/>")
        assert sc.parse_header(w)[0] == sc.MSG_TRACK
        assert sc.decode_track(w[8:]) == (3, b"http://u", b"<didl/>")
        w2 = sc.encode_metatext(9, b"title")
        assert sc.decode_metatext(w2[8:]) == (9, b"title")
        w3 = sc.encode_resend([5, 6, 9])
        assert sc.decode_resend(w3[8:]) == [5, 6, 9]


class TestOhmLoopback:
    def test_unicast_stream_in_order(self):
        got = []
        sender = sc.OhmSender(multicast=False)
        sender.start()
        rx = sc.OhmReceiver(lambda s, m: got.append((m.frame, s)),
                            multicast=False,
                            sender_endpoint=("127.0.0.1",
                                             sender.endpoint[1]))
        rx.start()
        time.sleep(0.3)       # join propagates
        tone = np.tile(
            np.rint(np.sin(np.arange(441) / 441 * 6.283) * 10000)
            .astype(np.int32), (2, 1))
        for i in range(5):
            sender.send_audio(tone, 44100, 16, sample_start=i * 441)
        deadline = time.time() + 5
        while len(got) < 5 and time.time() < deadline:
            time.sleep(0.05)
        rx.stop()
        sender.stop()
        assert len(got) == 5
        frames = [f for f, _ in got]
        assert frames == sorted(frames)
        np.testing.assert_array_equal(got[0][1], tone)

    def test_resend_recovers_loss(self):
        got = []
        sender = sc.OhmSender(multicast=False)
        sender.start()
        rx = sc.OhmReceiver(lambda s, m: got.append(m.frame),
                            multicast=False,
                            sender_endpoint=("127.0.0.1",
                                             sender.endpoint[1]))
        rx.start()
        time.sleep(0.3)
        tone = np.zeros((2, 441), np.int32)
        # frame 1 delivered; frame 2 "lost" (history only); frame 3 sent
        sender.send_audio(tone, 44100, 16)
        real_tx = sender._tx
        sender._tx = lambda pkt: None          # drop on the wire
        f2 = sender.send_audio(tone, 44100, 16)
        sender._tx = real_tx
        sender.send_audio(tone, 44100, 16)
        deadline = time.time() + 5
        while len(got) < 3 and time.time() < deadline:
            time.sleep(0.05)
        rx.stop()
        sender.stop()
        assert got == [1, 2, 3]
        assert rx.stats.resends_requested >= 1


class TestScd:
    def test_tcp_stream(self):
        got, meta, halts = [], [], []
        sender = scd_mod.ScdSender()
        rx = scd_mod.ScdReceiver("127.0.0.1", sender.port,
                                 lambda s, f: got.append(s),
                                 on_metadata=meta.append,
                                 on_halt=lambda: halts.append(1))
        rx.start()
        time.sleep(0.2)
        fmt = scd_mod.ScdFormat(48000, 24, 2, samples_total=480)
        sender.send_format(fmt)
        sender.send_metadata("<didl>x</didl>")
        pcm = np.arange(-480, 480, dtype=np.int32).reshape(2, -1)
        sender.send_audio(pcm, 24)
        sender.send_halt()
        deadline = time.time() + 5
        while (not got or not halts) and time.time() < deadline:
            time.sleep(0.05)
        rx.stop()
        sender.close()
        assert rx.format.sample_rate == 48000
        np.testing.assert_array_equal(got[0], pcm)
        assert meta == ["<didl>x</didl>"] and halts == [1]


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


class TestOdp:
    def test_full_control_surface(self, media_player):
        server = OdpServer()
        server.add_device(make_device(media_player))
        client = OdpClient("127.0.0.1", server.port)
        try:
            assert client.devices and "Transport" in client.devices[0]["services"]
            # product
            assert client.invoke("Product", "Room")["value"] == "Main Room"
            assert client.invoke("Product", "SourceCount")["value"] == 2
            # volume (also evented)
            client.subscribe("Volume")
            client.invoke("Volume", "SetVolume", value=55)
            assert client.invoke("Volume", "Volume")["value"] == 55
            deadline = time.time() + 3
            while time.time() < deadline:
                if any(p["name"] == "Volume" and p["value"] == 55
                       for n in client.notifications
                       for p in n.get("properties", [])):
                    break
                time.sleep(0.05)
            else:
                raise AssertionError("no volume notify")
            # playlist db
            nid = client.invoke("Playlist", "Insert", afterId=0,
                                uri="tone://sine.wav?duration=1")["newId"]
            arr = client.invoke("Playlist", "IdArray")["array"]
            assert arr == [nid]
            got = client.invoke("Playlist", "Read", id=nid)
            assert got["uri"].startswith("tone://")
            # config surface
            keys = client.invoke("Config", "Keys")["keys"]
            assert "Volume.Limit" in keys
            # errors surface as RuntimeError
            with pytest.raises(RuntimeError):
                client.invoke("Product", "NoSuchAction")
        finally:
            client.close()
            server.close()

    def test_transport_actions(self, media_player):
        server = OdpServer()
        server.add_device(make_device(media_player))
        client = OdpClient("127.0.0.1", server.port)
        try:
            client.subscribe("Transport")
            client.invoke("Transport", "PlayUri",
                          uri="tone://sine.wav?pitch=500&duration=1")
            # drain the pipeline output (no real animator in this test)
            from ohpipeline_jax.pipeline import AnimatorBatch
            chunks = []
            AnimatorBatch(media_player.pipeline.pipeline.predriver,
                          lambda s, i: chunks.append(s),
                          use_device=False).run()
            pcm = np.concatenate(chunks, axis=1)
            assert pcm.shape[1] == 44100
        finally:
            client.close()
            server.close()


class TestDebugService:
    def test_debug_surface(self, media_player):
        """ProviderDebug analogue (OpenHome/Av/ProviderDebug.h:48-63):
        GetLog dumps the ring buffer, SendLog requires a poster,
        LogBuffers reports reservoir occupancy, GetRecentMSearches
        reflects the SSDP observer, SendDeviceAnnouncements re-notifies."""
        import json as _json
        media_player.log.log("kernel", "pipeline started")
        media_player.log.log("net", "odp client connected")
        server = OdpServer()
        server.add_device(make_device(media_player))
        client = OdpClient("127.0.0.1", server.port)
        try:
            log = client.invoke("Debug", "GetLog")["value"]
            assert "pipeline started" in log and "[net]" in log
            bufs = client.invoke("Debug", "LogBuffers")
            assert "encoded_bytes" in bufs and "decoded_jiffies" in bufs
            # no poster configured -> SendLog errors (reference asserts)
            with pytest.raises(RuntimeError):
                client.invoke("Debug", "SendLog", data="tag")
            posted = []
            media_player.log_poster = \
                lambda log_text, data: posted.append((log_text, data))
            client.invoke("Debug", "SendLog", data="tag42")
            assert posted and posted[0][1] == "tag42" \
                and "pipeline started" in posted[0][0]
            # SSDP observer integration
            class FakeResponder:
                def __init__(self):
                    self.announced = 0

                def notify_alive(self):
                    self.announced += 1

                def recent_msearches(self):
                    return [("192.168.1.50", 2.5)]

            fr = FakeResponder()
            media_player.ssdp_responders.append(fr)
            arr = _json.loads(
                client.invoke("Debug", "GetRecentMSearches")["value"])
            assert arr == [{"address": "192.168.1.50",
                            "seconds_ago": 2.5}]
            client.invoke("Debug", "SendDeviceAnnouncements")
            assert fr.announced == 1
        finally:
            client.close()
            server.close()


class TestSsdpMsearchObserver:
    def test_recent_msearch_recording(self):
        """SsdpResponder keeps the last distinct M-SEARCH sources with
        ages (MSearchObserver, ProviderDebug.cpp:76-106)."""
        from ohpipeline_jax.net.upnp import SsdpResponder, UpnpDevice
        dev = UpnpDevice("Test", udn="uuid:test-1")
        r = SsdpResponder(dev, bind="127.0.0.1", port=0)
        try:
            for i in range(12):
                r._record_msearch((f"10.0.0.{i}", 1900))
            rec = r.recent_msearches()
            assert len(rec) == 10
            assert all(age >= 0 for _a, age in rec)
            # re-search from a known address refreshes, not duplicates
            r._record_msearch(("10.0.0.11", 1900))
            assert len(r.recent_msearches()) == 10
        finally:
            r.close() if hasattr(r, "close") else None

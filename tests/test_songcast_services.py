"""Songcast control-plane services: the Sender status machine
(ProviderSender, Av/Songcast/OhmSender.cpp:84-293), the Sender.* config
values (Av/Songcast/Sender.cpp:31-78), and the Receiver ODP service
(Av/Songcast/ProviderReceiver.cpp) over the upgraded SourceReceiver
SetSender semantics (SourceReceiver.cpp:340-418)."""

import time

import pytest

from ohpipeline_jax.av.config import ConfigManager
from ohpipeline_jax.av.receiver_sources import SourceReceiver, UriError
from ohpipeline_jax.av.sender import (STATUS_BLOCKED, STATUS_DISABLED,
                                      STATUS_ENABLED, STATUS_INACTIVE,
                                      STATUS_READY, STATUS_SENDING,
                                      SenderStatus, SongcastSender)


class _FakeOhm:
    multicast = True
    channel = 0


class TestSenderStatus:
    """Exact UpdateStatusEnabledLocked / UpdateStatus2Locked truth table
    (OhmSender.cpp:254-289)."""

    def test_initial_disabled(self):
        st = SenderStatus()
        assert st.status == STATUS_DISABLED
        assert st.status2 == STATUS_DISABLED

    def test_enabled_ready_until_listeners_and_audio(self):
        st = SenderStatus()
        st.set_status_enabled(True)
        assert st.status == STATUS_ENABLED
        assert st.status2 == STATUS_READY      # no listeners, no audio
        st.notify_listeners(True)
        assert st.status2 == STATUS_READY      # listeners but no audio
        st.notify_audio_playing(True)
        assert st.status2 == STATUS_SENDING
        st.close()

    def test_blocked_and_inactive_precedence(self):
        st = SenderStatus()
        st.set_status_enabled(True)
        st.notify_listeners(True)
        st.notify_audio_playing(True)
        st.set_status_blocked(True)
        assert st.status == STATUS_BLOCKED
        assert st.status2 == STATUS_BLOCKED
        st.set_status_blocked(False)
        st.notify_broadcast_allowed(False)
        assert st.status == STATUS_ENABLED     # Status ignores broadcast
        assert st.status2 == STATUS_INACTIVE
        # disabled beats everything
        st.set_status_enabled(False)
        assert st.status == STATUS_DISABLED
        assert st.status2 == STATUS_DISABLED
        st.close()

    def test_audio_present_timeout_clears(self, monkeypatch):
        monkeypatch.setattr("ohpipeline_jax.av.sender.TIMEOUT_AUDIO_S",
                            0.05)
        st = SenderStatus()
        st.set_status_enabled(True)
        st.notify_listeners(True)
        events = []
        st.add_observer(lambda p, v: events.append((p, v)))
        st.notify_audio_playing(True)
        assert st.status2 == STATUS_SENDING
        deadline = time.time() + 2
        while st.status2 != STATUS_READY and time.time() < deadline:
            time.sleep(0.01)
        assert st.status2 == STATUS_READY      # timer cleared Audio
        assert ("Audio", False) in events
        st.close()

    def test_observer_events(self):
        st = SenderStatus()
        events = []
        st.add_observer(lambda p, v: events.append((p, v)))
        st.set_status_enabled(True)
        assert ("Status", STATUS_ENABLED) in events
        assert ("Enabled", True) in events
        assert ("Status2", STATUS_READY) in events
        st.close()


class TestSongcastSenderConfig:
    """Sender.* config values drive the OhmSender and status
    (Sender.cpp:324-349)."""

    def make(self):
        cm = ConfigManager()
        ohm = _FakeOhm()
        s = SongcastSender(cm, ohm, name="room", default_channel=1234)
        return cm, ohm, s

    def test_defaults_applied_at_construction(self):
        cm, ohm, s = self.make()
        assert ohm.channel == 1234
        assert ohm.multicast is False          # default Unicast
        assert s.provider.status == STATUS_ENABLED

    def test_config_changes_propagate(self):
        cm, ohm, s = self.make()
        cm.get("Sender.Channel").set(4321)
        assert ohm.channel == 4321
        cm.get("Sender.Mode").set(0)           # Multicast
        assert ohm.multicast is True
        cm.get("Sender.Enabled").set(0)        # No
        assert s.provider.status == STATUS_DISABLED
        cm.get("Sender.Enabled").set(1)
        assert s.provider.status == STATUS_ENABLED

    def test_own_receiver_mode_blocks_and_overrides(self):
        cm, ohm, s = self.make()
        overrides = []
        s.add_unicast_override_observer(overrides.append)
        s.on_mode("Receiver")                  # device plays its own rx
        assert s.provider.status == STATUS_BLOCKED
        assert overrides == [True]
        s.on_mode("Playlist")
        assert s.provider.status == STATUS_ENABLED
        assert overrides == [True, False]

    def test_pipeline_state_drives_audio(self):
        cm, ohm, s = self.make()
        s.provider.notify_listeners(True)
        s.notify_pipeline_state("playing")
        assert s.provider.status2 == STATUS_SENDING
        s.notify_pipeline_state("stopped")
        assert s.provider.status2 == STATUS_READY
        s.close()


class TestSourceReceiverSetSender:
    """SetSender URI handling incl. the ohz zone rules
    (SourceReceiver.cpp:340-398)."""

    def make(self):
        from ohpipeline_jax.av.config import RamStore
        from ohpipeline_jax.pipeline import PipelineManager
        from ohpipeline_jax.pipeline.manager import PipelineInitParams
        p = PipelineInitParams()
        p.gorge_jiffies = 0
        p.threaded_starvation_ramper = False
        mgr = PipelineManager(p)
        store = RamStore()
        src = SourceReceiver(mgr, store=store)
        return mgr, store, src

    def test_direct_uri_persists(self):
        mgr, store, src = self.make()
        try:
            src.set_sender("ohm://239.253.1.1:51970", "<didl/>")
            assert src.sender_info() == ("ohm://239.253.1.1:51970",
                                         "<didl/>")
            assert store.read("Receiver.Uri") == b"ohm://239.253.1.1:51970"
            assert store.read("Receiver.Zone") == b""
        finally:
            mgr.quit()

    def test_zone_uri_accepted_and_bad_rejected(self):
        mgr, store, src = self.make()
        try:
            src.set_sender("ohz://239.255.255.250:51972/kitchen")
            assert src.zone == "kitchen"
            assert store.read("Receiver.Zone") == b"kitchen"
            # wrong endpoint (cpp:363-368)
            with pytest.raises(UriError):
                src.set_sender("ohz://239.255.255.251:51972/kitchen")
            # missing /zone path (cpp:369-371)
            with pytest.raises(UriError):
                src.set_sender("ohz://239.255.255.250:51972")
            with pytest.raises(UriError):
                src.set_sender("ohz://239.255.255.250:51972/")
        finally:
            mgr.quit()

    def test_persisted_selection_restored(self):
        mgr, store, src = self.make()
        try:
            src.set_sender("ohm://10.0.0.1:51970", "m")
        finally:
            mgr.quit()
        from ohpipeline_jax.pipeline import PipelineManager
        from ohpipeline_jax.pipeline.manager import PipelineInitParams
        p = PipelineInitParams()
        p.gorge_jiffies = 0
        p.threaded_starvation_ramper = False
        mgr2 = PipelineManager(p)
        try:
            src2 = SourceReceiver(mgr2, store=store)
            assert src2.sender_info() == ("ohm://10.0.0.1:51970", "m")
            assert src2.uri == "ohm://10.0.0.1:51970"
        finally:
            mgr2.quit()


class TestZoneDiscoveryLoopback:
    """OHZ query/answer between two unicast handlers feeds
    ZoneUriChanged (ZoneHandler listener, SourceReceiver.cpp:405-418)."""

    def test_zone_query_answer_callback(self):
        from ohpipeline_jax.net.songcast import ZoneHandler
        answering = ZoneHandler("kitchen", ohm_uri="ohm://127.0.0.1:5555",
                                multicast=False)
        asking = ZoneHandler("", multicast=False)
        got = []
        asking.on_zone_uri = lambda z, u: got.append((z, u))
        answering.start()
        asking.start()
        try:
            deadline = time.time() + 3
            while not got and time.time() < deadline:
                asking.query("kitchen", target=answering.endpoint)
                time.sleep(0.05)
            assert got and got[0] == ("kitchen", "ohm://127.0.0.1:5555")
            assert asking.discovered["kitchen"] == "ohm://127.0.0.1:5555"
        finally:
            answering.stop()
            asking.stop()


@pytest.fixture
def media_player():
    from ohpipeline_jax.av import MediaPlayer, MediaPlayerInitParams
    from ohpipeline_jax.pipeline.manager import PipelineInitParams
    pp = PipelineInitParams()
    pp.gorge_jiffies = 0
    pp.threaded_starvation_ramper = False
    mp = MediaPlayer(MediaPlayerInitParams(pipeline_params=pp))
    mp.add_source(SourceReceiver(mp.pipeline, store=mp.store))
    mp.add_songcast_sender(ohm=_FakeOhm(), default_channel=7)
    mp.start()
    yield mp
    mp.quit()


class TestOdpSongcastServices:
    def test_receiver_service_surface(self, media_player):
        from ohpipeline_jax.net.odp import OdpClient, OdpError, OdpServer
        from ohpipeline_jax.net.providers import make_device
        server = OdpServer()
        server.add_device(make_device(media_player))
        client = OdpClient("127.0.0.1", server.port)
        try:
            services = client.devices[0]["services"]
            assert "Receiver" in services and "Sender" in services
            # ProtocolInfo constant (SourceReceiver.cpp:191)
            assert client.invoke("Receiver", "ProtocolInfo")["value"] == \
                "ohz:*:*:*,ohm:*:*:*,ohu:*.*.*"
            # SetSender round-trips through the store
            client.invoke("Receiver", "SetSender",
                          uri="ohm://239.253.1.1:51970", metadata="<m/>")
            got = client.invoke("Receiver", "Sender")
            assert got["Uri"] == "ohm://239.253.1.1:51970"
            assert got["Metadata"] == "<m/>"
            # bad zone uri -> 800 (ProviderReceiver.cpp:15-16, 63-70)
            with pytest.raises(OdpError) as e:
                client.invoke("Receiver", "SetSender",
                              uri="ohz://1.2.3.4:5/zone")
            assert e.value.code == 800
            assert client.invoke("Receiver",
                                 "TransportState")["value"] == "Stopped"
        finally:
            client.close()
            server.close()

    def test_sender_service_surface(self, media_player):
        from ohpipeline_jax.net.odp import OdpClient, OdpServer
        from ohpipeline_jax.net.providers import make_device
        server = OdpServer()
        server.add_device(make_device(media_player))
        client = OdpClient("127.0.0.1", server.port)
        try:
            assert client.invoke("Sender", "Status")["value"] == "Enabled"
            assert client.invoke("Sender", "Status2")["value"] == "Ready"
            assert client.invoke("Sender", "Enabled")["value"] is True
            assert "<DIDL-Lite>" in \
                client.invoke("Sender", "Metadata")["value"]
            assert client.invoke("Sender", "Audio")["value"] is False
            # config flips the evented status
            media_player.config.get("Sender.Enabled").set(0)
            assert client.invoke("Sender", "Status")["value"] == "Disabled"
        finally:
            client.close()
            server.close()


class TestDriverSongcastSender:
    """AnimatorSongcastSender (Av/Utils/DriverSongcastSender.cpp): the
    pipeline renders into OHM frames, and the Silencer keeps silence
    flowing after the source halts so receivers stay clock-locked."""

    def test_pipeline_to_ohm_with_silence_fill(self):
        import numpy as np
        from ohpipeline_jax.net.songcast import OhmSender
        from ohpipeline_jax.pipeline import PipelineManager
        from ohpipeline_jax.pipeline.animator import AnimatorSongcastSender
        from ohpipeline_jax.pipeline.manager import PipelineInitParams

        p = PipelineInitParams()
        p.gorge_jiffies = 0
        p.threaded_starvation_ramper = False
        mgr = PipelineManager(p)
        sent = []

        class FakeOhm(OhmSender):
            def __init__(self):
                pass   # no socket

            def send_audio(self, samples, sample_rate, bit_depth,
                           sample_start=0, samples_total=0, halt=False):
                sent.append((samples.shape[1], sample_start,
                             bool(np.any(samples)), halt))
                return 0

        an = AnimatorSongcastSender(mgr.pipeline.predriver, FakeOhm(),
                                    realtime=False)
        mgr.play_uri("tone://sine.wav?pitch=500&duration=1")
        an.start()
        deadline = time.time() + 15
        # 1s of tone then the silencer keeps frames flowing post-halt
        while time.time() < deadline:
            audio = sum(n for n, _, nz, _ in sent if nz)
            silence = sum(n for n, _, nz, _ in sent if not nz)
            if audio >= 44100 and silence >= 4410:
                break
            time.sleep(0.05)
        an.quit()
        mgr.quit()
        audio = sum(n for n, _, nz, _ in sent if nz)
        silence = sum(n for n, _, nz, _ in sent if not nz)
        assert audio >= 44100, (audio, silence)
        assert silence >= 4410, (audio, silence)
        # sample positions run monotonically
        positions = [s for _, s, _, _ in sent]
        assert positions == sorted(positions)

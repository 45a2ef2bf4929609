"""Pins: the id-addressed PinsManager contract (Av/Pins/Pins.cpp) and
the Pins ODP service with the ProviderPins error table
(Av/Pins/ProviderPins.cpp:19-30)."""

import json

import pytest

from ohpipeline_jax.av.config import RamStore
from ohpipeline_jax.av.pins import (ID_EMPTY, Pin, PinIdNotFound,
                                    PinIndexOutOfRange,
                                    PinModeNotSupported, PinNothingToPlay,
                                    PinsManager, PinUriError, PinInvoker)


class RecordingInvoker(PinInvoker):
    def __init__(self, mode="rec", versions=(1,)):
        self.mode = mode
        self.supported_versions = versions
        self.invoked = []

    def invoke(self, pin):
        self.invoked.append(pin)


class TestPinsManagerContract:
    def make(self, store=None):
        pins = PinsManager(store or RamStore())
        inv = RecordingInvoker()
        pins.add_invoker(inv)
        return pins, inv

    def test_ids_assigned_nonzero_and_fresh(self):
        pins, inv = self.make()
        assert pins.id_array() == [ID_EMPTY] * pins.device_max
        pins.set(0, "rec", uri="a://x")
        pins.set(1, "rec", uri="a://y")
        ids = pins.id_array()
        assert ids[0] != ID_EMPTY and ids[1] != ID_EMPTY
        assert ids[0] != ids[1]
        # re-setting a slot mints a NEW id (Pin::Set -> NextId)
        old = ids[0]
        pins.set(0, "rec", uri="a://z")
        assert pins.id_array()[0] not in (ID_EMPTY, old)

    def test_typed_failures(self):
        pins, inv = self.make()
        with pytest.raises(PinModeNotSupported):
            pins.set(0, "nosuch", uri="a://x")
        with pytest.raises(PinUriError):
            pins.set(0, "rec", uri="")
        with pytest.raises(PinIndexOutOfRange):
            pins.set(99, "rec", uri="a://x")
        with pytest.raises(PinIndexOutOfRange):
            pins.swap(0, 99)
        with pytest.raises(PinIdNotFound):
            pins.clear(12345)
        with pytest.raises(PinIdNotFound):
            pins.clear(ID_EMPTY)       # kIdEmpty never matches
        with pytest.raises(PinModeNotSupported):
            pins.invoke_index(0)       # empty slot

    def test_version_param_validated_when_present(self):
        pins, _ = self.make()
        pins.set(0, "rec", uri="rec://album?version=1&id=3")
        with pytest.raises(PinUriError):
            pins.set(1, "rec", uri="rec://album?version=2&id=3")
        with pytest.raises(PinUriError):
            pins.set(1, "rec", uri="rec://album?version=bogus")

    def test_clear_and_invoke_by_id(self):
        pins, inv = self.make()
        pins.set(2, "rec", uri="a://x", title="T")
        pid = pins.id_array()[2]
        pins.invoke_id(pid)
        assert inv.invoked and inv.invoked[0].title == "T"
        pins.clear(pid)
        assert pins.id_array()[2] == ID_EMPTY
        with pytest.raises(PinIdNotFound):
            pins.invoke_id(pid)

    def test_write_json_reference_shape(self):
        pins, _ = self.make()
        pins.set(0, "rec", type="album", uri="a://x", title="T",
                 description="D", artwork_uri="http://art", shuffle=True)
        pid = pins.id_array()[0]
        got = json.loads(pins.write_json([pid, 777]))  # 777 skipped
        assert got == [{"id": pid, "mode": "rec", "type": "album",
                        "uri": "a://x", "title": "T", "description": "D",
                        "artworkUri": "http://art", "shuffle": True}]

    def test_invoke_uri_one_shot(self):
        pins, inv = self.make()
        pins.invoke_uri("rec", "track", "a://once", shuffle=True)
        assert inv.invoked[0].uri == "a://once"
        assert pins.id_array() == [ID_EMPTY] * pins.device_max

    def test_persistence_keeps_ids_monotonic(self):
        store = RamStore()
        pins, _ = self.make(store)
        pins.set(0, "rec", uri="a://x")
        old_id = pins.id_array()[0]
        pins2, _ = self.make(store)
        assert pins2.id_array()[0] == old_id
        pins2.set(1, "rec", uri="a://y")
        assert pins2.id_array()[1] > old_id    # provider resumes past max

    def test_nothing_to_play_from_catalogue_invoker(self):
        from ohpipeline_jax.av.pins import ServiceCatalogPinInvoker
        inv = ServiceCatalogPinInvoker("svc", lambda k, i: [], None, None)
        with pytest.raises(PinNothingToPlay):
            inv.invoke(Pin(mode="svc", uri="svc://album/1"))


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


class TestOdpPinsService:
    def test_full_surface_and_error_codes(self, media_player):
        from ohpipeline_jax.net.odp import OdpClient, OdpError, OdpServer
        from ohpipeline_jax.net.providers import make_device
        server = OdpServer()
        server.add_device(make_device(media_player))
        client = OdpClient("127.0.0.1", server.port)
        try:
            assert "Pins" in client.devices[0]["services"]
            assert client.invoke("Pins", "GetDeviceMax")["value"] == 6
            assert client.invoke("Pins", "GetAccountMax")["value"] == 0
            modes = json.loads(client.invoke("Pins", "GetModes")["value"])
            assert {"transport", "url", "radio", "playlist"} <= set(modes)
            client.invoke("Pins", "SetDevice", index=0, mode="url",
                          uri="http://radio/x", title="X")
            ids = json.loads(client.invoke("Pins", "GetIdArray")["value"])
            assert ids[0] != 0
            lst = json.loads(client.invoke("Pins", "ReadList",
                                           ids=json.dumps([ids[0]]))
                             ["value"])
            assert lst[0]["uri"] == "http://radio/x"
            # error table (ProviderPins.cpp:19-30)
            with pytest.raises(OdpError) as e:
                client.invoke("Pins", "SetDevice", index=77, mode="url",
                              uri="u://x")
            assert e.value.code == 801
            with pytest.raises(OdpError) as e:
                client.invoke("Pins", "Clear", id=999)
            assert e.value.code == 802
            with pytest.raises(OdpError) as e:
                client.invoke("Pins", "InvokeUri", mode="nosuch")
            assert e.value.code == 803
            with pytest.raises(OdpError) as e:
                client.invoke("Pins", "SetDevice", index=1, mode="url",
                              uri="")
            assert e.value.code == 806
            client.invoke("Pins", "Clear", id=ids[0])
            ids2 = json.loads(client.invoke("Pins", "GetIdArray")["value"])
            assert ids2[0] == 0
        finally:
            client.close()
            server.close()

    def test_id_array_evented(self, media_player):
        from ohpipeline_jax.net.providers import make_pins_service
        svc = make_pins_service(media_player)
        events = []
        svc._subscribe(lambda name, props: events.append(props))
        media_player.pins.set(3, "transport", uri="play")
        assert any("IdArray" in p for p in events)
        pid = media_player.pins.id_array()[3]
        assert pid != 0

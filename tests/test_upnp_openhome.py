"""The openhome provider family over UPnP: one provider table serving
both planes — ODP services bridged to av-openhome-org SOAP services with
GENA eventing and the provider error codes as SOAP faults (the reference
publishes its providers through ohNet's UPnP stack,
MediaPlayer.cpp provider registration)."""

import json
import threading
import time
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import pytest

from ohpipeline_jax.net import upnp


@pytest.fixture
def player_device():
    from ohpipeline_jax.av import MediaPlayer, MediaPlayerInitParams
    from ohpipeline_jax.pipeline.manager import PipelineInitParams
    pp = PipelineInitParams()
    pp.gorge_jiffies = 0
    pp.threaded_starvation_ramper = False
    mp = MediaPlayer(MediaPlayerInitParams(pipeline_params=pp))
    mp.start()
    dev = upnp.make_openhome_device(mp)
    dev.start(ssdp=False)
    yield mp, dev
    dev.close()
    mp.quit()


def svc_type(name):
    return f"urn:av-openhome-org:service:{name}:1"


class TestOpenhomeUpnp:
    def test_provider_family_published(self, player_device):
        mp, dev = player_device
        base = f"http://127.0.0.1:{dev.port}"
        with urllib.request.urlopen(f"{base}/description.xml") as r:
            desc = r.read().decode()
        for name in ("Product", "Volume", "Info", "Transport", "Playlist",
                     "Radio", "Time", "Credentials", "OAuth", "Config",
                     "Debug", "Pins"):
            assert svc_type(name) in desc, name

    def test_soap_actions_share_provider_table(self, player_device):
        mp, dev = player_device
        base = f"http://127.0.0.1:{dev.port}"
        got = upnp.soap_call(base, "ohProduct", svc_type("Product"),
                             "Manufacturer")
        assert got["Name"] == "OpenHome"
        upnp.soap_call(base, "ohVolume", svc_type("Volume"),
                       "SetVolume", {"value": 42})
        assert mp.volumes.volume == 42          # same VolumeManager
        got = upnp.soap_call(base, "ohVolume", svc_type("Volume"),
                             "Volume")
        assert got["value"] == "42"
        # bool wire is 1/0 (ohNet style)
        got = upnp.soap_call(base, "ohProduct", svc_type("Product"),
                             "Standby")
        assert got["value"] in ("0", "1")

    def test_provider_error_codes_as_soap_faults(self, player_device):
        mp, dev = player_device
        base = f"http://127.0.0.1:{dev.port}"
        # first over-max set clamps to max (VolumeManager.cpp:150-160);
        # the second, already pinned at max, faults 811
        upnp.soap_call(base, "ohVolume", svc_type("Volume"),
                       "SetVolume", {"value": 99999})
        with pytest.raises(upnp.UpnpError) as e:
            upnp.soap_call(base, "ohVolume", svc_type("Volume"),
                           "SetVolume", {"value": 99999})
        assert e.value.code == 811              # Volume invalid
        with pytest.raises(upnp.UpnpError) as e:
            upnp.soap_call(base, "ohPins", svc_type("Pins"),
                           "Clear", {"id": 777})
        assert e.value.code == 802              # Pin id not found

    def test_playlist_roundtrip_and_typed_args(self, player_device):
        mp, dev = player_device
        base = f"http://127.0.0.1:{dev.port}"
        new = upnp.soap_call(base, "ohPlaylist", svc_type("Playlist"),
                             "Insert",
                             {"afterId": 0, "uri": "http://a/1.flac",
                              "metadata": "<m/>"})
        nid = int(new["newId"])
        xml = upnp.soap_call(base, "ohPlaylist", svc_type("Playlist"),
                             "ReadList", {"idList": str(nid)})["value"]
        assert f"<Id>{nid}</Id>" in xml
        # shuffle takes a SOAP bool string
        upnp.soap_call(base, "ohPlaylist", svc_type("Playlist"),
                       "SetShuffle", {"value": "true"})
        assert mp.source_playlist.provider.shuffle is True

    def test_gena_eventing_from_provider_properties(self, player_device):
        mp, dev = player_device
        base = f"http://127.0.0.1:{dev.port}"
        bodies, got = [], threading.Event()

        class H(BaseHTTPRequestHandler):
            def log_message(self, *a):
                pass

            def do_NOTIFY(self):
                ln = int(self.headers.get("Content-Length", 0))
                bodies.append(self.rfile.read(ln).decode())
                got.set()
                self.send_response(200)
                self.send_header("Content-Length", "0")
                self.end_headers()

        srv = ThreadingHTTPServer(("127.0.0.1", 0), H)
        threading.Thread(target=srv.serve_forever, daemon=True).start()
        try:
            req = urllib.request.Request(f"{base}/ohVolume/event",
                                         method="SUBSCRIBE")
            req.add_header(
                "Callback",
                f"<http://127.0.0.1:{srv.server_address[1]}/>")
            req.add_header("NT", "upnp:event")
            with urllib.request.urlopen(req, timeout=10) as r:
                assert r.headers["SID"].startswith("uuid:")
            assert got.wait(5), "initial NOTIFY missing"
            bodies.clear()
            mp.volumes.set_volume(37)
            deadline = time.monotonic() + 5
            while time.monotonic() < deadline:
                if any("<Volume>37</Volume>" in b for b in bodies):
                    break
                time.sleep(0.05)
            else:
                raise AssertionError(bodies)
        finally:
            srv.shutdown()

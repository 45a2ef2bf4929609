"""UPnP control plane over loopback (reference TestUpnpErrors /
TestDvDevice style): description + SCPD serving, SOAP actions driving
the pipeline and volume, GENA subscriptions receiving LastChange
notifies, SSDP M-SEARCH discovery, and SOAP faults."""

import threading
import time
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import pytest

from ohpipeline_jax.av.config import ConfigManager
from ohpipeline_jax.av.volume import VolumeManager, VolumeProfile
from ohpipeline_jax.net import upnp
from ohpipeline_jax.pipeline import AnimatorBatch, PipelineManager
from ohpipeline_jax.pipeline.manager import PipelineInitParams


class NotifySink:
    """Tiny GENA callback server collecting NOTIFY bodies."""

    def __init__(self):
        sink = self
        self.bodies = []
        self.event = threading.Event()

        class H(BaseHTTPRequestHandler):
            def log_message(self, *a):
                pass

            def do_NOTIFY(self):
                ln = int(self.headers.get("Content-Length", 0))
                sink.bodies.append(self.rfile.read(ln).decode())
                sink.event.set()
                self.send_response(200)
                self.send_header("Content-Length", "0")
                self.end_headers()

        self.server = ThreadingHTTPServer(("127.0.0.1", 0), H)
        threading.Thread(target=self.server.serve_forever,
                         daemon=True).start()

    @property
    def url(self):
        return f"http://127.0.0.1:{self.server.server_address[1]}/"

    def wait_for(self, needle: str, timeout=5.0) -> bool:
        end = time.monotonic() + timeout
        while time.monotonic() < end:
            if any(needle in b for b in self.bodies):
                return True
            time.sleep(0.05)
        return False


@pytest.fixture
def renderer():
    params = PipelineInitParams()
    params.gorge_jiffies = 0
    params.threaded_starvation_ramper = False
    pm = PipelineManager(params)
    cm = ConfigManager()
    vm = VolumeManager(cm, VolumeProfile(max_volume=100, default_volume=40,
                                         default_limit=100))
    dev = upnp.make_av_renderer(pm, vm)
    dev.start()
    yield dev, pm, vm
    dev.close()
    pm.quit()


AVT = "urn:schemas-upnp-org:service:AVTransport:1"
RCS = "urn:schemas-upnp-org:service:RenderingControl:1"
CMGR = "urn:schemas-upnp-org:service:ConnectionManager:1"


class TestDescription:
    def test_description_and_scpd(self, renderer):
        dev, _, _ = renderer
        base = f"http://127.0.0.1:{dev.port}"
        with urllib.request.urlopen(f"{base}/description.xml") as r:
            desc = r.read().decode()
        assert "MediaRenderer:1" in desc
        assert "AVTransport" in desc and "RenderingControl" in desc
        with urllib.request.urlopen(f"{base}/AVTransport/scpd.xml") as r:
            scpd = r.read().decode()
        assert "<name>Play</name>" in scpd


class TestSoapControl:
    def test_play_pause_volume(self, renderer):
        dev, pm, vm = renderer
        base = f"http://127.0.0.1:{dev.port}"
        uri = ("tone://sine.wav?pitch=1000&duration=1&samplerate=44100"
               "&bitdepth=16&channels=2")
        upnp.soap_call(base, "AVTransport", AVT, "SetAVTransportURI",
                       {"InstanceID": 0, "CurrentURI": uri,
                        "CurrentURIMetaData": ""})
        upnp.soap_call(base, "AVTransport", AVT, "Play",
                       {"InstanceID": 0, "Speed": "1"})
        info = upnp.soap_call(base, "AVTransport", AVT,
                              "GetTransportInfo", {"InstanceID": 0})
        assert info["CurrentTransportState"] in ("PLAYING",
                                                 "TRANSITIONING")
        # audio actually flows
        chunks = []
        animator = AnimatorBatch(pm.pipeline.predriver,
                                 lambda s, i: chunks.append(s),
                                 use_device=False)
        animator.run()
        pcm = np.concatenate(chunks, axis=1)
        assert pcm.shape[1] == 44100
        # volume via RenderingControl
        upnp.soap_call(base, "RenderingControl", RCS, "SetVolume",
                       {"InstanceID": 0, "Channel": "Master",
                        "DesiredVolume": 66})
        assert vm.volume == 66
        got = upnp.soap_call(base, "RenderingControl", RCS, "GetVolume",
                             {"InstanceID": 0, "Channel": "Master"})
        assert got["CurrentVolume"] == "66"
        upnp.soap_call(base, "RenderingControl", RCS, "SetMute",
                       {"InstanceID": 0, "Channel": "Master",
                        "DesiredMute": "1"})
        assert vm.muted

    def test_protocol_info_lists_codecs(self, renderer):
        dev, _, _ = renderer
        base = f"http://127.0.0.1:{dev.port}"
        out = upnp.soap_call(base, "ConnectionManager", CMGR,
                             "GetProtocolInfo", {})
        assert "audio/flac" in out["Sink"] and "audio/opus" in out["Sink"]

    def test_soap_fault_on_bad_action(self, renderer):
        dev, _, _ = renderer
        base = f"http://127.0.0.1:{dev.port}"
        with pytest.raises(upnp.UpnpError) as ei:
            upnp.soap_call(base, "AVTransport", AVT, "NoSuchAction", {})
        assert ei.value.code == 401
        # Play without a URI -> 716
        with pytest.raises(upnp.UpnpError) as ei:
            upnp.soap_call(base, "AVTransport", AVT, "Play",
                           {"InstanceID": 0, "Speed": "1"})
        assert ei.value.code == 716


class TestGena:
    def test_lastchange_events(self, renderer):
        dev, pm, vm = renderer
        base = f"http://127.0.0.1:{dev.port}"
        sink = NotifySink()
        req = urllib.request.Request(
            f"{base}/RenderingControl/event", method="SUBSCRIBE")
        req.add_header("Callback", f"<{sink.url}>")
        req.add_header("NT", "upnp:event")
        req.add_header("TIMEOUT", "Second-1800")
        with urllib.request.urlopen(req, timeout=10) as r:
            sid = r.headers["SID"]
        assert sid.startswith("uuid:")
        assert sink.wait_for("LastChange"), "initial NOTIFY missing"
        sink.bodies.clear()
        vm.set_volume(73)
        assert sink.wait_for('Volume val="73"'), sink.bodies
        # unsubscribe stops delivery
        req = urllib.request.Request(
            f"{base}/RenderingControl/event", method="UNSUBSCRIBE")
        req.add_header("SID", sid)
        with urllib.request.urlopen(req, timeout=10):
            pass
        sink.bodies.clear()
        vm.set_volume(50)
        time.sleep(0.3)
        assert not sink.bodies


class TestSsdp:
    def test_msearch_discovery(self, renderer):
        dev, _, _ = renderer
        resp = upnp.SsdpResponder(dev, bind="127.0.0.1", port=0)
        resp.start()
        time.sleep(0.1)
        found = upnp.msearch("urn:schemas-upnp-org:device:MediaRenderer:1",
                             timeout=1.0,
                             addr=("127.0.0.1", resp.port))
        resp.close()
        assert found, "no SSDP response"
        assert any("MediaRenderer" in h.get("ST", "") for h in found)
        assert any(dev.location in h.get("LOCATION", "") for h in found)

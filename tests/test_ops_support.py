"""Tests: OHZ zone discovery (loopback), reboot/fault/buffered-log, and
the observer thread."""

import time

import pytest

from ohpipeline_jax.av.ops_support import BufferedLog, FaultCode, RebootHandler
from ohpipeline_jax.net import songcast as sc
from ohpipeline_jax.pipeline.observer import ObserverSync, ObserverThread


class TestOhz:
    def test_wire_roundtrip(self):
        q = sc.encode_zone_query("kitchen")
        t, f = sc.parse_ohz(q)
        assert t == sc.OHZ_QUERY and f["zone"] == "kitchen"
        u = sc.encode_zone_uri("kitchen", "ohm://239.1.2.3:51970")
        t, f = sc.parse_ohz(u)
        assert t == sc.OHZ_ZONE_URI and f["uri"].startswith("ohm://")

    def test_discovery_loopback(self):
        sender = sc.ZoneHandler("den", "ohm://239.9.9.9:51970",
                                multicast=False)
        sender.start()
        rx = sc.ZoneHandler("", multicast=False)
        rx.start()
        rx.query("den", target=("127.0.0.1", sender.endpoint[1]))
        deadline = time.time() + 3
        while "den" not in rx.discovered and time.time() < deadline:
            time.sleep(0.05)
        sender.stop()
        rx.stop()
        assert rx.discovered.get("den") == "ohm://239.9.9.9:51970"


class TestOpsSupport:
    def test_reboot_handler(self):
        done = []
        rh = RebootHandler(done.append)
        rh.reboot("update applied")
        assert done == ["update applied"]

    def test_fault_codes(self):
        FaultCode.reset_all()
        fc = FaultCode("Codec.Unsupported")
        assert FaultCode.active_faults() == []
        fc.set("vorbis requested")
        assert FaultCode.active_faults() == [("Codec.Unsupported",
                                              "vorbis requested")]
        fc.clear()
        assert FaultCode.active_faults() == []

    def test_buffered_log_and_poster(self):
        posted = []
        log = BufferedLog(max_lines=3, poster=posted.append)
        log.enable("media")
        log.enable("debug", False)
        log.log("media", "one")
        log.log("debug", "hidden")
        log.log("media", "two")
        dump = log.dump()
        assert "one" in dump and "two" in dump and "hidden" not in dump
        assert log.post() and "two" in posted[0]


class TestObserverThread:
    def test_async_delivery_and_flush(self):
        ot = ObserverThread()
        got = []
        for i in range(10):
            ot.schedule(got.append, i)
        ot.flush()
        ot.quit()
        assert got == list(range(10))

    def test_sync_double(self):
        got = []
        ObserverSync().schedule(got.append, 7)
        assert got == [7]

    def test_observer_exceptions_do_not_kill_thread(self):
        ot = ObserverThread()
        got = []
        ot.schedule(lambda: 1 / 0)
        ot.schedule(got.append, "after")
        ot.flush()
        ot.quit()
        assert got == ["after"]

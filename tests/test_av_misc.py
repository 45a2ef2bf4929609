"""Tests for the small Av components (OhMetadata/KvpStore/MuteManager/
MimeTypeList/FriendlyName/TransportRepeatRandom/ArtworkServer)."""

import urllib.request

from ohpipeline_jax.av.config import ConfigManager
from ohpipeline_jax.av.misc import (FriendlyNameManager, KvpStore,
                                    MimeTypeList, MuteManager,
                                    TrackMetadata, TransportRepeatRandom,
                                    didl_lite, parse_didl_lite)
from ohpipeline_jax.av.product import Product
from ohpipeline_jax.net.artwork import ArtworkServer


class TestOhMetadata:
    def test_didl_roundtrip(self):
        md = TrackMetadata(title="Song & Dance", artist="A<B>", album="Al",
                           genre="Jazz", artwork_uri="http://x/art.jpg",
                           duration_s=3723, bitrate=320000,
                           uri="http://x/a.flac")
        back = parse_didl_lite(didl_lite(md))
        assert back.title == "Song & Dance"
        assert back.artist == "A<B>"
        assert back.duration_s == 3723
        assert back.bitrate == 320000
        assert back.uri == "http://x/a.flac"

    def test_parse_tolerates_garbage(self):
        assert parse_didl_lite("").title == ""
        assert parse_didl_lite("<not-xml").title == ""


class TestKvpStore:
    def test_defaults_and_overrides(self):
        s = KvpStore({"Model.Name": "custom"})
        assert s.get("Model.Name") == "custom"
        assert s.has("Manufacturer.Name")


class TestMuteManager:
    def test_aggregate_and_clients(self):
        calls = []

        class C:
            def __init__(self, n):
                self.n = n

            def mute(self):
                calls.append((self.n, True))

            def unmute(self):
                calls.append((self.n, False))

        mm = MuteManager()
        mm.register("vol", C("vol"))
        mm.register("bt", C("bt"))
        states = []
        mm.add_observer(states.append)
        mm.mute("vol")
        mm.mute("bt")
        mm.unmute("vol")
        assert mm.muted           # bt still muted
        mm.unmute("bt")
        assert not mm.muted
        assert states == [True, False]     # aggregate edges only


class TestMimeTypes:
    def test_populate_from_registry(self):
        from ohpipeline_jax.codecs import default_registry
        ml = MimeTypeList()
        ml.populate_from_registry(default_registry)
        assert "audio/flac" in ml.types
        assert "audio/mpeg" in ml.types
        assert "http-get:*:audio/wav:*" in ml.protocol_info()


class TestFriendlyName:
    def test_composed_and_notified(self):
        prod = Product(ConfigManager(), "Den", "Box")
        fn = FriendlyNameManager(prod)
        seen = []
        fn.register(seen.append)
        assert seen == ["Den:Box"]
        prod.room_cfg.set("Loft")
        assert seen[-1] == "Loft:Box"


class TestRepeatRandom:
    def test_observers(self):
        tr = TransportRepeatRandom()
        seen = []
        tr.add_observer(lambda r, s: seen.append((r, s)))
        tr.set_repeat(True)
        tr.set_random(True)
        tr.set_repeat(True)       # no-op
        assert seen == [(False, False), (True, False), (True, True)]


class TestArtwork:
    def test_serve_and_observe(self):
        srv = ArtworkServer()
        uris = []
        srv.add_observer(uris.append)
        srv.set_artwork("image/jpeg", b"JPEGDATA")
        with urllib.request.urlopen(uris[-1], timeout=5) as r:
            assert r.read() == b"JPEGDATA"
            assert r.headers["Content-Type"] == "image/jpeg"
        srv.clear()
        assert uris[-1] == ""
        srv.close()

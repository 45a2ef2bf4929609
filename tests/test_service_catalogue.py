"""Tidal/Qobuz catalogue + token-lifecycle depth against canned API
responses (the reference's live-API suites skip the same way,
SURVEY.md §4.8; parity: Av/Tidal/TidalMetadata.cpp + TidalPins.cpp,
Av/Qobuz/Qobuz.cpp)."""

import json
import urllib.parse

import pytest

from ohpipeline_jax.av.credentials import Credentials
from ohpipeline_jax.av.misc import didl_lite
from ohpipeline_jax.av.pins import Pin, qobuz_pin_invoker, tidal_pin_invoker
from ohpipeline_jax.av.services import (QobuzCatalogue, QobuzService,
                                        ServiceError, TidalCatalogue,
                                        TidalService, TokenRefreshLoop)


class RamStore:
    def __init__(self):
        self._d = {}

    def read(self, k):
        from ohpipeline_jax.av.config import StoreKeyNotFound
        if k not in self._d:
            raise StoreKeyNotFound(k)
        return self._d[k]

    def write(self, k, v):
        self._d[k] = v

    def delete(self, k):
        self._d.pop(k, None)


def _track(i, title=None):
    return {"id": i, "title": title or f"Track {i}", "duration": 200 + i,
            "artists": [{"name": "Artist A"}],
            "album": {"title": "Album X", "cover": "ab-cd-ef"}}


class FakeTidalApi:
    """Scripted Tidal API: paged album tracks + 401-then-ok auth."""

    def __init__(self, ntracks=120, fail_first_auth=False):
        self.ntracks = ntracks
        self.fail_next = fail_first_auth
        self.calls = []

    def http(self, method, url, headers, body=b""):
        self.calls.append(url)
        if self.fail_next:
            self.fail_next = False
            return 401, b"{}"
        q = urllib.parse.parse_qs(urllib.parse.urlparse(url).query)
        path = urllib.parse.urlparse(url).path
        if "/albums/77/tracks" in path:
            off = int(q.get("offset", ["0"])[0])
            lim = int(q.get("limit", ["50"])[0])
            items = [_track(i) for i in range(off,
                                              min(off + lim, self.ntracks))]
            return 200, json.dumps(
                {"items": items,
                 "totalNumberOfItems": self.ntracks}).encode()
        if "/tracks/5" in path:
            return 200, json.dumps(_track(5, "Solo")).encode()
        if "/search/tracks" in path:
            return 200, json.dumps({"items": [_track(9)]}).encode()
        if "/users/u1/favorites/tracks" in path:
            return 200, json.dumps(
                {"items": [{"item": _track(3)}],
                 "totalNumberOfItems": 1}).encode()
        return 404, b"{}"


def _tidal(api):
    svc = TidalService(RamStore(), "client-id", http=api.http,
                      http_post=lambda url, data, hdrs: {})
    # pre-seed a valid token so catalogue calls skip the OAuth flow
    from ohpipeline_jax.av.oauth import Token
    tok = Token("t1", refresh_token="r1")
    tok.access_token = "acc"
    tok.expires_at = 2e12
    svc.tokens._tokens["t1"] = tok
    return svc


def test_tidal_catalogue_paging_and_metadata():
    api = FakeTidalApi(ntracks=120)
    cat = TidalCatalogue(_tidal(api))
    tracks = cat.album_tracks("77", "t1")
    assert len(tracks) == 120
    assert tracks[0].title == "Track 0"
    assert tracks[0].artist == "Artist A"
    assert tracks[0].album == "Album X"
    assert tracks[0].uri == "tidal://track/0"
    assert "ab/cd/ef" in tracks[0].artwork_uri
    # three pages of 50
    assert sum("offset=0" in c for c in api.calls) == 1
    assert sum("offset=100" in c for c in api.calls) == 1
    didl = didl_lite(tracks[0])
    assert "<dc:title>Track 0</dc:title>" in didl


def test_tidal_single_track_favorites_and_search():
    api = FakeTidalApi()
    cat = TidalCatalogue(_tidal(api))
    t = cat.track("5", "t1")
    assert t.title == "Solo"
    favs = cat.favorite_tracks("u1", "t1")
    assert len(favs) == 1 and favs[0].uri == "tidal://track/3"
    hits = cat.search("solo", "t1")
    assert hits and hits[0].uri == "tidal://track/9"


def test_tidal_catalogue_auth_retry():
    api = FakeTidalApi(fail_first_auth=True)
    cat = TidalCatalogue(_tidal(api))
    t = cat.track("5", "t1")               # 401 then retried OK
    assert t.title == "Solo"


class FakeQobuzApi:
    def __init__(self):
        self.logged_in = False

    def http(self, method, url, headers, body=b""):
        path = urllib.parse.urlparse(url).path
        q = urllib.parse.parse_qs(urllib.parse.urlparse(url).query)
        if "/user/login" in path:
            self.logged_in = True
            return 200, json.dumps({"user_auth_token": "qt"}).encode()
        if not self.logged_in or headers.get("X-User-Auth-Token") != "qt":
            return 401, b"{}"
        if "/album/get" in path:
            return 200, json.dumps({
                "title": "QAlbum", "artist": {"name": "QA"},
                "image": {"large": "http://img/q.jpg"},
                "tracks": {"items": [
                    {"id": 1, "title": "Q1", "duration": 100,
                     "performer": {"name": "QA"}},
                    {"id": 2, "title": "Q2", "duration": 110,
                     "performer": {"name": "QA"}}]}}).encode()
        if "/playlist/get" in path:
            off = int(q.get("offset", ["0"])[0])
            items = [{"id": 10 + i, "title": f"P{10 + i}", "duration": 90,
                      "performer": {"name": "QB"},
                      "album": {"title": "PA"}}
                     for i in range(off, min(off + 50, 60))]
            return 200, json.dumps(
                {"tracks": {"items": items, "total": 60}}).encode()
        return 404, b"{}"


def _qobuz(api):
    creds = Credentials(RamStore())
    svc = QobuzService(creds, "app", "sec", http=api.http)
    creds.set(svc.ID, "user", b"pw")
    return svc


def test_qobuz_catalogue():
    api = FakeQobuzApi()
    cat = QobuzCatalogue(_qobuz(api))
    tracks = cat.album_tracks("9")
    assert [t.title for t in tracks] == ["Q1", "Q2"]
    assert tracks[0].album == "QAlbum"
    assert tracks[0].artwork_uri == "http://img/q.jpg"
    pl = cat.playlist_tracks("p7")
    assert len(pl) == 60 and pl[0].uri == "qobuz://track/10"


class FakePlaylistSource:
    system_name = "Playlist"

    def __init__(self):
        from ohpipeline_jax.av.sources import TrackDatabase
        self.db = TrackDatabase()
        self.provider = type("P", (), {"set_shuffle": lambda s, v: None})()
        self.activated = False

    def activate(self, auto_play=False):
        self.activated = auto_play


class FakeProduct:
    def __init__(self):
        self.selected = None

    def set_source_by_name(self, name):
        self.selected = name


def test_tidal_pin_loads_album_into_playlist():
    api = FakeTidalApi(ntracks=4)
    cat = TidalCatalogue(_tidal(api))
    src = FakePlaylistSource()
    prod = FakeProduct()
    inv = tidal_pin_invoker(cat, "t1", src, prod)
    inv.invoke(Pin(mode="tidal", uri="tidal://album/77"))
    assert prod.selected == "Playlist"
    assert src.activated
    ids = src.db.id_array()
    assert len(ids) == 4


def test_qobuz_pin_loads_playlist():
    api = FakeQobuzApi()
    cat = QobuzCatalogue(_qobuz(api))
    src = FakePlaylistSource()
    prod = FakeProduct()
    inv = qobuz_pin_invoker(cat, src, prod)
    inv.invoke(Pin(mode="qobuz", uri="qobuz://playlist/p7"))
    assert len(src.db.id_array()) == 60


def test_token_refresh_loop_smoke():
    calls = []

    class TM:
        _tokens = {"a": None}

        def access_token(self, tid):
            calls.append(tid)
            return "x"
    loop = TokenRefreshLoop(TM(), interval_s=0.05)
    loop.start()
    import time
    time.sleep(0.2)
    loop.stop()
    assert calls

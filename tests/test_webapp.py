"""WebAppFramework + ConfigUi tests over loopback HTTP (reference
TestWebAppFramework: session create, long-poll delivery, resource
serving, tab reaping semantics)."""

import json
import threading
import urllib.error
import urllib.request

import pytest

from ohpipeline_jax.av.config import ConfigManager
from ohpipeline_jax.net.webapp import ConfigApp, Tab, WebApp, WebAppFramework


def get(url):
    with urllib.request.urlopen(url, timeout=10) as r:
        return r.status, r.read()


def post(url, obj):
    req = urllib.request.Request(url, json.dumps(obj).encode(),
                                 method="POST")
    with urllib.request.urlopen(req, timeout=10) as r:
        return r.status, r.read()


@pytest.fixture
def framework():
    fw = WebAppFramework()
    fw.start()
    yield fw
    fw.close()


class EchoApp(WebApp):
    name = "echo"

    def resource(self, path):
        if path == "index.html":
            return ("text/html", b"<html>echo</html>")
        return None

    def tab_created(self, tab):
        tab.send({"type": "hello", "tab": tab.id})

    def receive(self, tab, message):
        tab.send({"type": "echo", "got": message})


class TestFramework:
    def test_resources_and_app_list(self, framework):
        framework.add_app(EchoApp())
        base = f"http://127.0.0.1:{framework.port}"
        status, body = get(f"{base}/")
        assert status == 200 and b"echo" in body
        status, body = get(f"{base}/echo/")
        assert body == b"<html>echo</html>"
        with pytest.raises(urllib.error.HTTPError):
            get(f"{base}/echo/missing.js")

    def test_longpoll_session_flow(self, framework):
        framework.add_app(EchoApp())
        base = f"http://127.0.0.1:{framework.port}/echo"
        _, body = get(f"{base}/lpcreate")
        sid = json.loads(body)["session-id"]
        _, body = get(f"{base}/lp?session-id={sid}")
        msgs = json.loads(body)
        assert {"type": "hello", "tab": sid} in msgs
        post(f"{base}/send?session-id={sid}", {"ping": 1})
        _, body = get(f"{base}/lp?session-id={sid}")
        assert json.loads(body)[0]["got"] == {"ping": 1}
        get(f"{base}/lpterminate?session-id={sid}")
        with pytest.raises(urllib.error.HTTPError):
            get(f"{base}/lp?session-id={sid}")


class TestConfigUi:
    def test_meta_updates_and_set(self, framework):
        cm = ConfigManager()
        vol = cm.create_num("Volume.Limit", 0, 100, 85)
        cm.create_choice("Mode", {0: "Off", 1: "On"}, 1)
        cm.create_text("Room", 20, "Den")
        framework.add_app(ConfigApp(cm))
        base = f"http://127.0.0.1:{framework.port}/config"
        _, body = get(f"{base}/meta.json")
        meta = {m["key"]: m for m in json.loads(body)}
        assert meta["Volume.Limit"]["type"] == "num"
        assert meta["Volume.Limit"]["max"] == 100
        assert meta["Mode"]["type"] == "choice"
        _, body = get(f"{base}/lpcreate")
        sid = json.loads(body)["session-id"]
        # initial state push includes every key
        _, body = get(f"{base}/lp?session-id={sid}")
        keys = {m["key"] for m in json.loads(body) if m["type"] == "update"}
        assert {"Volume.Limit", "Mode", "Room"} <= keys
        # set via the UI message path; change shows up in config + longpoll
        post(f"{base}/send?session-id={sid}", {"type": "set",
                                               "key": "Volume.Limit",
                                               "value": 70})
        assert vol.value == 70
        _, body = get(f"{base}/lp?session-id={sid}")
        ups = [m for m in json.loads(body) if m["key"] == "Volume.Limit"]
        assert ups and ups[-1]["value"] == 70
        # invalid set surfaces an error message
        post(f"{base}/send?session-id={sid}", {"type": "set",
                                               "key": "Volume.Limit",
                                               "value": 1000})
        _, body = get(f"{base}/lp?session-id={sid}")
        assert any(m["type"] == "error" for m in json.loads(body))
        assert vol.value == 70

    def test_tab_subscriptions_released_on_terminate(self, framework):
        cm = ConfigManager()
        vol = cm.create_num("Volume.Limit", 0, 100, 85)
        app = ConfigApp(cm)
        framework.add_app(app)
        base = f"http://127.0.0.1:{framework.port}/config"
        before = len(vol._observers)
        _, body = get(f"{base}/lpcreate")
        sid = json.loads(body)["session-id"]
        assert len(vol._observers) == before + 1
        get(f"{base}/lpterminate?session-id={sid}")
        # reaped/terminated tabs must unsubscribe their config callbacks
        assert len(vol._observers) == before
        assert not app._subs


class TestStaticResources:
    def test_file_resources_mime_etag_304(self, framework, tmp_path):
        """File-backed resource serving (reference FileResourceHandler):
        extension MIME mapping, ETag issued, If-None-Match -> 304."""
        from ohpipeline_jax.net.webapp import (FileResourceManager,
                                               WebApp)
        (tmp_path / "app.css").write_text("body{}")
        (tmp_path / "logo.svg").write_text("<svg/>")

        class FileApp(WebApp):
            name = "files"
        app = FileApp()
        app.resources = FileResourceManager(str(tmp_path))
        framework.add_app(app)
        port = framework.port
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}/files/app.css")
        with urllib.request.urlopen(req, timeout=10) as r:
            assert r.status == 200
            assert r.headers["Content-Type"] == "text/css"
            assert "max-age" in r.headers.get("Cache-Control", "")
            etag = r.headers["ETag"]
            assert r.read() == b"body{}"
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}/files/app.css",
            headers={"If-None-Match": etag})
        try:
            with urllib.request.urlopen(req, timeout=10) as r:
                assert r.status == 304
        except urllib.error.HTTPError as e:   # urllib treats 304 as error
            assert e.code == 304
        st, body = get(f"http://127.0.0.1:{port}/files/logo.svg")
        assert st == 200

    def test_language_directories(self, framework, tmp_path):
        """Per-language resource dirs chosen from Accept-Language
        (reference languageResourceDir handling)."""
        from ohpipeline_jax.net.webapp import (FileResourceManager,
                                               WebApp)
        (tmp_path / "greet.txt").write_text("hello")
        (tmp_path / "fr").mkdir()
        (tmp_path / "fr" / "greet.txt").write_text("bonjour")

        class LangApp(WebApp):
            name = "lang"
        app = LangApp()
        app.resources = FileResourceManager(str(tmp_path),
                                            languages=("fr",))
        framework.add_app(app)
        port = framework.port
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}/lang/greet.txt",
            headers={"Accept-Language": "fr, en;q=0.5"})
        with urllib.request.urlopen(req, timeout=10) as r:
            assert r.read() == b"bonjour"
        st, body = get(f"http://127.0.0.1:{port}/lang/greet.txt")
        assert body == b"hello"

    def test_traversal_rejected(self, framework, tmp_path):
        from ohpipeline_jax.net.webapp import FileResourceManager
        (tmp_path / "safe.txt").write_text("ok")
        mgr = FileResourceManager(str(tmp_path))
        assert mgr.lookup("safe.txt") is not None
        assert mgr.lookup("../webapp.py") is None
        assert mgr.lookup("..%2F..%2Fetc%2Fpasswd") is None

    def test_config_index_served_from_file(self, framework):
        cm = ConfigManager.__new__(ConfigManager)  # minimal: keys only
        cm._values = {}
        cm.keys = lambda: []
        cm.get = lambda k: None
        cm.has = lambda k: False
        framework.add_app(ConfigApp(cm))
        st, body = get(f"http://127.0.0.1:{framework.port}/config/")
        assert st == 200 and b"StartLongPolling" in body
        assert b"config.js" in body


class TestConfigUiClientApp:
    """The generated config web app (reference ConfigUi/res: index.html
    + webconfig.js + lang/en-gb/ConfigOptions.txt): typed widgets built
    from meta.json, a language resource for choice display strings, and
    the Reboot control (the value round-trips themselves are covered by
    TestConfigUi above)."""

    def test_client_app_resources(self, framework):
        """config.js ships the generated app: it references exactly the
        endpoints the framework serves, renders typed widgets, and the
        language resource resolves through the per-language dir."""
        cm = ConfigManager()
        cm.create_num("Volume.Limit", 0, 100, 85)
        framework.add_app(ConfigApp(cm))
        base = f"http://127.0.0.1:{framework.port}/config"
        st, js = get(f"{base}/config.js")
        assert st == 200
        for endpoint in (b"meta.json", b"lpcreate", b"lp?session-id=",
                         b"send?session-id=", b"lpterminate"):
            assert endpoint in js, endpoint
        for widget in (b"select", b"number", b"maxLength",
                       b"RebootButton", b"ConfigValContainer"):
            assert widget in js, widget
        # language resource only resolves with a matching language
        req = urllib.request.Request(
            f"{base}/ConfigOptions.txt",
            headers={"Accept-Language": "en-gb"})
        with urllib.request.urlopen(req, timeout=10) as r:
            text = r.read().decode()
        assert "Sender.Mode" in text and "Multicast" in text
        with pytest.raises(urllib.error.HTTPError):
            get(f"{base}/ConfigOptions.txt")  # only in the lang dirs

    def test_reboot_control(self, framework):
        cm = ConfigManager()
        cm.create_num("Volume.Limit", 0, 100, 85)
        rebooted = []
        framework.add_app(ConfigApp(cm,
                                    on_reboot=lambda: rebooted.append(1)))
        base = f"http://127.0.0.1:{framework.port}/config"
        _, body = get(f"{base}/lpcreate")
        sid = json.loads(body)["session-id"]
        post(f"{base}/send?session-id={sid}", {"type": "reboot"})
        assert rebooted


class TestSessionEviction:
    def test_idle_tab_evicted_when_full(self, framework, monkeypatch):
        """At the session cap, lpcreate recycles the longest-idle tab
        instead of failing, but refuses when every tab is active
        (reference TabManager + TabAllocatorFull semantics)."""
        import ohpipeline_jax.net.webapp as W
        framework.add_app(EchoApp())
        port = framework.port
        sids = []
        for _ in range(W.MAX_TABS):
            st, body = get(f"http://127.0.0.1:{port}/echo/lpcreate")
            sids.append(json.loads(body)["session-id"])
        # all tabs fresh -> allocator full
        with pytest.raises(urllib.error.HTTPError) as ei:
            get(f"http://127.0.0.1:{port}/echo/lpcreate")
        assert ei.value.code == 503
        # age the first tab far past the long-poll window -> recycled
        with framework._lock:
            framework._tabs[sids[0]][1].last_seen -= 1000.0
        st, body = get(f"http://127.0.0.1:{port}/echo/lpcreate")
        assert st == 200
        with framework._lock:
            assert sids[0] not in framework._tabs

"""Credentials/OAuth/Pins/service-client tests (reference TestCredentials,
TestOAuth, TestPins, TestQobuz-with-fakes style)."""

import json
import time

import numpy as np
import pytest

from ohpipeline_jax.av.config import RamStore
from ohpipeline_jax.av.credentials import Credentials
from ohpipeline_jax.av.oauth import (DeviceCodeRequest, OAuthDeviceFlow,
                                     TokenManager)
from ohpipeline_jax.av.pins import (Pin, PinsManager, TransportPinInvoker,
                                    UrlPinInvoker)
from ohpipeline_jax.av import services as SVC


class TestCredentials:
    def test_roundtrip_encrypted_at_rest(self):
        store = RamStore()
        c = Credentials(store)
        c.add("qobuz.com")
        c.set("qobuz.com", "alice", b"s3cret")
        user, pw = c.get("qobuz.com")
        assert (user, pw) == ("alice", b"s3cret")
        # at rest the password must NOT be plaintext
        raw = store.read("Credentials.qobuz.com.Password")
        assert b"s3cret" not in raw
        # same store, fresh instance: key + creds persist (the service
        # re-registers its id each boot, reference Credentials::Add)
        c2 = Credentials(store)
        c2.add("qobuz.com")
        assert c2.get("qobuz.com") == ("alice", b"s3cret")
        # unregistered ids throw (Credentials.cpp Get -> Find)
        from ohpipeline_jax.av.credentials import CredentialsIdNotFound
        with pytest.raises(CredentialsIdNotFound):
            c2.get("tidal.com")

    def test_control_point_encrypts_with_public_key(self):
        from cryptography.hazmat.primitives import serialization
        from cryptography.hazmat.primitives.asymmetric import padding
        c = Credentials(RamStore())
        c.add("svc")
        pub = serialization.load_pem_public_key(c.public_key_pem().encode())
        blob = pub.encrypt(b"networkpw", padding.PKCS1v15())
        c.set("svc", "bob", blob)
        assert c.get("svc") == ("bob", b"networkpw")

    def test_observers_and_clear(self):
        c = Credentials(RamStore())
        c.add("svc")
        seen = []
        c.subscribe("svc", lambda: seen.append(1))
        c.set("svc", "u", b"p")
        c.clear("svc")
        assert len(seen) == 2
        assert c.get("svc") == ("", b"")


class FakeAuthServer:
    """Scripted device-flow endpoint (the reference's TestPipe-style
    mock)."""

    def __init__(self, authorise_after=2):
        self.polls = 0
        self.authorise_after = authorise_after

    def post(self, url, data, headers):
        if "device_authorization" in url or url.endswith("/auth"):
            return {"device_code": "DEV", "user_code": "ABCD",
                    "verification_uri": "https://x/activate",
                    "interval": 0.01, "expires_in": 60}
        if data.get("grant_type", "").endswith("device_code"):
            self.polls += 1
            if self.polls < self.authorise_after:
                return {"error": "authorization_pending"}
            return {"access_token": "AT1", "refresh_token": "RT1",
                    "expires_in": 3600}
        if data.get("grant_type") == "refresh_token":
            return {"access_token": f"AT-{data['refresh_token']}",
                    "expires_in": 3600}
        raise AssertionError(url)


class TestOAuth:
    def test_device_flow_to_tokens(self):
        srv = FakeAuthServer()
        flow = OAuthDeviceFlow("svc", "https://x/auth", "https://x/token",
                               "client1", http_post=srv.post)
        req = flow.begin()
        assert req.user_code == "ABCD"
        resp = flow.poll_until_authorised(req)
        assert resp["access_token"] == "AT1"
        store = RamStore()
        tm = TokenManager("svc", store, flow.refresh)
        tm.add_token("t1", resp["refresh_token"])
        assert tm.access_token("t1") == "AT-RT1"
        # persistence: fresh manager sees the refresh token
        tm2 = TokenManager("svc", store, flow.refresh)
        assert tm2.token_ids() == ["t1"]

    def test_token_slot_limits(self):
        tm = TokenManager("svc", RamStore(), lambda rt: {}, max_short=2)
        tm.add_token("a", "r1")
        tm.add_token("b", "r2")
        with pytest.raises(RuntimeError):
            tm.add_token("c", "r3")
        tm.remove_token("a")
        tm.add_token("c", "r3")


class TestPins:
    def test_set_invoke_persist(self):
        store = RamStore()
        calls = []

        class FakePm:
            def play(self):
                calls.append("play")

            def play_uri(self, uri, md=""):
                calls.append(("uri", uri))

        pm = FakePm()
        pins = PinsManager(store)
        pins.add_invoker(TransportPinInvoker(pm))
        pins.add_invoker(UrlPinInvoker(pm))
        pins.set_pin(0, Pin(mode="transport", uri="play", title="Play"))
        pins.set_pin(1, Pin(mode="url", uri="http://radio/x", title="X"))
        pins.invoke(0)
        pins.invoke(1)
        assert calls == ["play", ("uri", "http://radio/x")]
        with pytest.raises(LookupError):
            pins.invoke(2)
        # persisted across managers
        pins2 = PinsManager(store)
        assert pins2.pin(1).uri == "http://radio/x"

    def test_unknown_mode_rejected(self):
        pins = PinsManager(RamStore())
        with pytest.raises(KeyError):
            pins.set_pin(0, Pin(mode="nosuch", uri="x"))


class FakeHttp:
    def __init__(self, routes):
        self.routes = routes
        self.calls = []

    def __call__(self, method, url, headers, body=b""):
        self.calls.append((method, url))
        for prefix, resp in self.routes.items():
            if prefix in url:
                return 200, json.dumps(resp).encode()
        return 404, b"{}"


class TestServices:
    def test_qobuz_login_and_signed_stream_url(self):
        creds = Credentials(RamStore())
        http = FakeHttp({"user/login": {"user_auth_token": "UAT"},
                         "track/getFileUrl": {"url": "http://cdn/a.flac"}})
        q = SVC.QobuzService(creds, "app1", "secret1", http=http)
        creds.set(q.ID, "user@x", b"pw")
        assert q.login()
        assert q.stream_url("99") == "http://cdn/a.flac"
        assert "request_sig=" in http.calls[-1][1]

    def test_tidal_stream_url_with_token(self):
        store = RamStore()
        srv = FakeAuthServer(authorise_after=1)
        http = FakeHttp({"playbackinfo": {"urls": ["http://cdn/t.flac"]}})
        t = SVC.TidalService(store, "cid", http=http, http_post=srv.post)
        resp = t.oauth.poll_until_authorised(t.oauth.begin())
        t.tokens.add_token("u1", resp["refresh_token"])
        assert t.stream_url("42", "u1") == "http://cdn/t.flac"

    def test_calmradio_token_url(self):
        creds = Credentials(RamStore())
        http = FakeHttp({"get_token": {"token": "TOK"}})
        c = SVC.CalmRadioService(creds, http=http)
        creds.set(c.ID, "u", b"p")
        url = c.stream_url("http://streams.calm/chan1")
        assert url.startswith("http://streams.calm/chan1?user=u&token=TOK")

    def test_tunein_opml_parse_and_refresh(self):
        opml = """<opml version="1"><body>
          <outline type="audio" text="Station A" URL="http://a/s.mp3"/>
          <outline type="link" text="More" URL="http://x"/>
          <outline type="audio" text="Station B" URL="http://b/s.aac"/>
        </body></opml>"""
        http = lambda m, u, h, b=b"": (200, opml.encode())
        svc = SVC.TuneInService("pid", "user", http=http)
        from ohpipeline_jax.av.sources import PresetDatabase
        db = PresetDatabase()
        assert svc.refresh_into(db) == 2
        assert db.preset(0).uri == "http://a/s.mp3"
        assert db.preset(1).metadata == "Station B"

    def test_service_protocol_resolves_then_streams(self):
        streamed = []

        class FakeHttpProtocol:
            def initialise(self, supply, ids):
                pass

            def stream(self, uri):
                streamed.append(uri)
                from ohpipeline_jax.protocols.base import ProtocolStreamResult
                return ProtocolStreamResult.SUCCESS

        p = SVC.ServiceProtocol("tidal", lambda uri: "http://cdn/x.flac",
                                http_protocol=FakeHttpProtocol())
        p.initialise(None, None)
        assert p.recognise("tidal://track/9")
        p.stream("tidal://track/9")
        assert streamed == ["http://cdn/x.flac"]


class TestOAuthProvider:
    """ProviderOAuth surface (Av/ProviderOAuth.cpp): encrypted SetToken
    wire (RSA-OAEP AES key/IV + AES-CBC token with BE-uint16 content
    length, AESHelpers.cpp:16-40), clears, status JSON, updateId bumps,
    limited-input-flow jobs, error codes 800/803/804."""

    def make_mp(self):
        from ohpipeline_jax.av.media_player import MediaPlayer
        from ohpipeline_jax.av.oauth import OAuthDeviceFlow, TokenManager
        from ohpipeline_jax.net.providers import make_oauth_service
        mp = MediaPlayer()
        srv = FakeAuthServer()
        flow = OAuthDeviceFlow("tidal", "https://x/auth",
                               "https://x/token", "client1",
                               http_post=srv.post)
        tm = TokenManager("tidal", mp.store, flow.refresh)
        svc = make_oauth_service(mp)
        mp.oauth.add_service("tidal", tm, flow=flow)
        return mp, svc, tm

    @staticmethod
    def encrypt_token(public_pem: str, refresh: bytes):
        import base64
        import os as _os

        from cryptography.hazmat.primitives import hashes, serialization
        from cryptography.hazmat.primitives.asymmetric import padding
        from cryptography.hazmat.primitives.ciphers import (Cipher,
                                                            algorithms,
                                                            modes)
        pub = serialization.load_pem_public_key(public_pem.encode())
        key, iv = _os.urandom(16), _os.urandom(16)
        oaep = padding.OAEP(mgf=padding.MGF1(hashes.SHA1()),
                            algorithm=hashes.SHA1(), label=None)
        plain = len(refresh).to_bytes(2, "big") + refresh
        plain += b"\0" * (-len(plain) % 16)      # zero pad to block
        enc = Cipher(algorithms.AES(key), modes.CBC(iv)).encryptor()
        ct = enc.update(plain) + enc.finalize()
        b64 = lambda b: base64.b64encode(b).decode()   # noqa: E731
        return (b64(pub.encrypt(key, oaep)), b64(pub.encrypt(iv, oaep)),
                b64(ct))

    def test_set_token_encrypted_wire(self):
        import json as _json
        mp, svc, tm = self.make_mp()
        pem = svc.invoke("GetPublicKey", {})["value"]
        k, iv, tok = self.encrypt_token(pem, b"RT-secret")
        u0 = svc.invoke("GetUpdateId", {})["value"]
        svc.invoke("SetToken", {
            "ServiceId": "tidal", "TokenId": "cp-1",
            "AesKeyRsaEncrypted": k, "InitVectorRsaEncrypted": iv,
            "TokenAesEncrypted": tok, "IsLongLived": False})
        assert tm._tokens["cp-1"].refresh_token == "RT-secret"
        assert svc.invoke("GetUpdateId", {})["value"] > u0
        status = _json.loads(svc.invoke("GetServiceStatus", {})["value"])
        srv = [s for s in status["services"] if s["id"] == "tidal"][0]
        assert srv["shortLivedTokens"][0]["id"] == "cp-1"
        # token actually works: refresh through the fake service
        assert tm.access_token("cp-1") == "AT-RT-secret"

    def test_error_codes(self):
        from ohpipeline_jax.net.odp import OdpError
        mp, svc, tm = self.make_mp()
        pem = svc.invoke("GetPublicKey", {})["value"]
        k, iv, tok = self.encrypt_token(pem, b"RT")
        with pytest.raises(OdpError) as ei:
            svc.invoke("SetToken", {
                "ServiceId": "nosuch", "TokenId": "t",
                "AesKeyRsaEncrypted": k, "InitVectorRsaEncrypted": iv,
                "TokenAesEncrypted": tok})
        assert ei.value.code == 800
        with pytest.raises(OdpError) as ei:
            svc.invoke("SetToken", {
                "ServiceId": "tidal", "TokenId": "t",
                "AesKeyRsaEncrypted": "Z m9v",      # broken b64/rsa
                "InitVectorRsaEncrypted": iv,
                "TokenAesEncrypted": tok})
        assert ei.value.code == 803
        with pytest.raises(OdpError) as ei:
            svc.invoke("ClearToken",
                       {"ServiceId": "tidal", "TokenId": "absent"})
        assert ei.value.code == 804

    def test_clears_and_selection(self):
        mp, svc, tm = self.make_mp()
        tm.add_token("s1", "r1")
        tm.add_token("l1", "r2", long_lived=True)
        from ohpipeline_jax.net.odp import OdpError
        with pytest.raises(OdpError) as ei:      # wrong-kind clear
            svc.invoke("ClearLongLivedToken",
                       {"ServiceId": "tidal", "TokenId": "s1"})
        assert ei.value.code == 804
        svc.invoke("ClearShortLivedTokens", {"ServiceId": "tidal"})
        assert tm.token_ids() == ["l1"]
        svc.invoke("ClearAllTokens", {"ServiceId": "tidal"})
        assert tm.token_ids() == []

    def test_limited_input_flow_job(self):
        import json as _json
        import time as _time
        mp, svc, tm = self.make_mp()
        out = svc.invoke("BeginLimitedInputFlow", {"ServiceId": "tidal"})
        assert out["UserCode"] == "ABCD"
        assert out["LoginUrl"] == "https://x/activate"
        deadline = _time.time() + 5
        while _time.time() < deadline:
            jobs = _json.loads(svc.invoke("GetJobStatus", {})["value"])
            states = [j["status"] for s in jobs["services"]
                      for j in s["jobs"]]
            if states and states[0] != "InProgress":
                break
            _time.sleep(0.02)
        assert states == ["Complete"]
        # the poller landed the refresh token in the manager
        assert tm._tokens[out["JobId"]].refresh_token == "RT1"

"""Randomized property test for the volume chain.

SURVEY.md §4.1's per-element style pins individual transitions; this
drives the assembled VolumeManager (user -> limiter -> reporter ->
offset -> unity -> boost -> ramper -> muter -> sink, VolumeManager.cpp
:1059-1112) with random op sequences and checks every step against an
exact model of the reference semantics:

* VolumeUser clamp-to-max-or-throw (VolumeManager.cpp:150-160);
* VolumeLimiter pinned-at-limit throw + clamped stored current
  (cpp:229-255);
* VolumeSourceOffset zero-stays-silent + floor-at-zero (cpp:330-348);
* VolumeUnityGain VolumeNotSupported while active (cpp:408-418), with
  upstream stages recording state exactly as the reference does when
  the throw unwinds through them;
* VolumeSurroundBoost clamps (cpp:377-396);
* mute forces sink 0, unmute restores the chain value.
"""

import numpy as np
import pytest

from ohpipeline_jax.av.config import ConfigManager
from ohpipeline_jax.av.volume import (VolumeManager, VolumeNotSupported,
                                      VolumeOutOfRange, VolumeProfile)

MAX = 100


class Model:
    """Reference-semantics model of the chain, op for op."""

    def __init__(self, default_volume, default_limit):
        self.user = default_volume
        self.limit = default_limit
        self.lim_current = 0
        self.off_current = 0
        self.offset = 0
        self.unity = False
        self.unity_current = 0
        self.boost = 0
        self.boost_current = 0
        self.muted = False
        self.muter_current = 0
        self.sink = 0
        self.set_volume(default_volume, startup=True)

    # -- stage transfer functions, bottom-up ---------------------------
    def _muter_set(self, v):
        self.muter_current = v
        if not self.muted:
            self.sink = v

    def _boost_apply(self):
        v = self.boost_current
        if v != 0:
            v = max(0, v + self.boost)
        self._muter_set(v)

    def _boost_set(self, v):
        self.boost_current = v
        self._boost_apply()

    def _unity_set(self, v):
        if self.unity:
            raise VolumeNotSupported(v)
        self._boost_set(v)
        self.unity_current = v      # recorded only on successful push

    def _offset_apply(self, v):
        out = 0 if v == 0 else max(0, v + self.offset)
        self._unity_set(out)

    def _offset_set(self, v):
        self._offset_apply(v)      # may throw: upstream NOT recorded
        self.off_current = v

    def _limiter_set(self, v):
        if v > self.limit and self.lim_current >= self.limit:
            raise VolumeOutOfRange(v)
        self.lim_current = min(v, self.limit)   # clamped BEFORE the push
        self._offset_set(self.lim_current)

    # -- public ops -----------------------------------------------------
    def set_volume(self, v, startup=False):
        # VolumeManager::SetVolume unmutes BEFORE the push — even when
        # the push then throws (VolumeManager.cpp:1255-1271); startup
        # volume application bypasses the manager and does not unmute
        if not startup:
            self.unmute()
        if v < 0:
            raise VolumeOutOfRange(v)
        if v > MAX:
            if self.user < MAX:
                v = MAX
            else:
                raise VolumeOutOfRange(v)
        self._limiter_set(v)       # may throw: user volume NOT recorded
        self.user = v

    def set_volume_no_unmute(self, v):
        if v < 0:
            raise VolumeOutOfRange(v)
        if v > MAX:
            if self.user < MAX:
                v = MAX
            else:
                raise VolumeOutOfRange(v)
        self._limiter_set(v)
        self.user = v

    def volume_inc(self, no_unmute=False):
        try:
            (self.set_volume_no_unmute if no_unmute
             else self.set_volume)(self.user + 1)
        except VolumeOutOfRange:
            pass                   # ProviderVolume ErrorOutOfRange::Ignore

    def volume_dec(self, no_unmute=False):
        if self.user == 0:
            return                 # ProviderVolume::VolumeDec no-op
        try:
            (self.set_volume_no_unmute if no_unmute
             else self.set_volume)(self.user - 1)
        except VolumeOutOfRange:
            pass

    def set_offset(self, off):
        self.offset = off
        try:
            self._offset_apply(self.off_current)
        except VolumeNotSupported:
            pass

    def set_unity(self, enabled):
        self.unity = enabled
        try:
            self._boost_set(MAX if enabled else self.unity_current)
        except (VolumeNotSupported, VolumeOutOfRange):
            pass

    def set_boost(self, boost):
        self.boost = boost
        try:
            self._boost_apply()
        except (VolumeNotSupported, VolumeOutOfRange):
            pass

    def set_limit(self, limit):
        self.limit = limit
        try:
            self.lim_current = min(self.lim_current, limit)
            self._offset_set(self.lim_current)
        except (VolumeNotSupported, VolumeOutOfRange):
            pass

    def mute(self):
        self.muted = True
        self.sink = 0

    def unmute(self):
        self.muted = False
        self.sink = self.muter_current


@pytest.mark.parametrize("seed", [3, 17, 91])
def test_volume_monkey(seed):
    rng = np.random.default_rng(seed)
    profile = VolumeProfile(max_volume=MAX, default_volume=40,
                            default_limit=80)
    hw = []
    vm = VolumeManager(ConfigManager(), profile, hw=hw.append)
    model = Model(40, 80)

    def paired(step, op, model_fn, real_fn):
        """Run the model and the real chain; their exception type (or
        absence) must agree."""
        want = got = None
        try:
            model_fn()
        except (VolumeOutOfRange, VolumeNotSupported) as e:
            want = type(e)
        try:
            real_fn()
        except (VolumeOutOfRange, VolumeNotSupported) as e:
            got = type(e)
        assert got == want, \
            f"step {step} op {op}: exception {got} != model {want}"

    ops = ["set", "set_big", "set_neg", "inc", "dec", "mute", "unmute",
           "offset", "unity_on", "unity_off", "boost", "limit",
           "set_nounmute", "inc_nounmute", "dec_nounmute"]
    for step in range(400):
        op = ops[int(rng.integers(len(ops)))]
        if op == "set":
            v = int(rng.integers(0, MAX + 1))
            paired(step, op, lambda: model.set_volume(v),
                   lambda: vm.set_volume(v))
        elif op == "set_big":
            v = MAX + int(rng.integers(1, 30))
            paired(step, op, lambda: model.set_volume(v),
                   lambda: vm.set_volume(v))
        elif op == "set_neg":
            v = -int(rng.integers(1, 10))
            paired(step, op, lambda: model.set_volume(v),
                   lambda: vm.set_volume(v))
        elif op == "set_nounmute":
            v = int(rng.integers(0, MAX + 10))
            paired(step, op, lambda: model.set_volume_no_unmute(v),
                   lambda: vm.set_volume_no_unmute(v))
        elif op == "inc":
            paired(step, op, model.volume_inc, vm.volume_inc)
        elif op == "dec":
            paired(step, op, model.volume_dec, vm.volume_dec)
        elif op == "inc_nounmute":
            paired(step, op, lambda: model.volume_inc(no_unmute=True),
                   vm.volume_inc_no_unmute)
        elif op == "dec_nounmute":
            paired(step, op, lambda: model.volume_dec(no_unmute=True),
                   vm.volume_dec_no_unmute)
        elif op == "mute":
            paired(step, op, model.mute, vm.mute)
        elif op == "unmute":
            paired(step, op, model.unmute, vm.unmute)
        elif op == "offset":
            off = int(rng.integers(-20, 21))
            paired(step, op, lambda: model.set_offset(off),
                   lambda: vm.offset.set_offset(off))
        elif op == "unity_on":
            paired(step, op, lambda: model.set_unity(True),
                   lambda: vm.unity.set_unity_gain(True))
        elif op == "unity_off":
            paired(step, op, lambda: model.set_unity(False),
                   lambda: vm.unity.set_unity_gain(False))
        elif op == "boost":
            b = int(rng.integers(-15, 16))
            paired(step, op, lambda: model.set_boost(b),
                   lambda: vm.set_volume_boost(b))
        elif op == "limit":
            lim = int(rng.integers(0, MAX + 1))
            paired(step, op, lambda: model.set_limit(lim),
                   lambda: vm.limiter._limit.set(lim))
        assert vm.volume == model.user, \
            f"step {step} op {op}: user {vm.volume} != model {model.user}"
        assert vm.muted == model.muted
        sink = hw[-1] if hw else 0
        assert sink == model.sink, \
            f"step {step} op {op}: sink {sink} != model {model.sink}"
        assert 0 <= sink, "sink went negative"
        if not model.unity:
            # offset (<=20) and surround boost (<=15) stack on top of max
            assert sink <= MAX + 35, "sink far beyond range"


def test_odp_volume_full_surface():
    """The complete ProviderVolume action/property surface over the ODP
    wire (ProviderVolume.cpp:181-253): Characteristics, balance/fade
    inc/dec, NoUnmute variants, UnityGain, per-channel VolumeOffset/Trim
    with the JSON-evented collections and error codes 812/816/817/819."""
    import json as _json

    from ohpipeline_jax.av.media_player import MediaPlayer
    from ohpipeline_jax.net.odp import OdpClient, OdpError, OdpServer
    from ohpipeline_jax.net.providers import make_device

    mp = MediaPlayer()
    server = OdpServer()
    server.add_device(make_device(mp))
    try:
        client = OdpClient("127.0.0.1", server.port)
        try:
            ch = client.invoke("Volume", "Characteristics")
            prof = mp.volumes.profile
            assert ch["VolumeMax"] == prof.max_volume
            assert ch["VolumeMilliDbPerStep"] == prof.milli_db_per_step
            assert ch["BalanceMax"] == prof.balance_max

            # NoUnmute: mute survives a volume change
            client.invoke("Volume", "SetMute", value=True)
            client.invoke("Volume", "SetVolumeNoUnmute", value=30)
            assert client.invoke("Volume", "Mute")["value"] is True
            client.invoke("Volume", "VolumeIncNoUnmute")
            assert client.invoke("Volume", "Volume")["value"] == 31
            assert client.invoke("Volume", "Mute")["value"] is True
            client.invoke("Volume", "SetVolume", value=32)   # unmutes
            assert client.invoke("Volume", "Mute")["value"] is False

            # balance/fade inc/dec + 812 beyond BalanceMax
            client.invoke("Volume", "SetBalance", value=prof.balance_max)
            with pytest.raises(OdpError) as ei:
                client.invoke("Volume", "SetBalance",
                              value=prof.balance_max + 1)
            assert ei.value.code == 812
            client.invoke("Volume", "BalanceInc")   # ignored at max
            assert client.invoke("Volume", "Balance")["value"] \
                == prof.balance_max
            client.invoke("Volume", "BalanceDec")
            assert client.invoke("Volume", "Balance")["value"] \
                == prof.balance_max - 1
            client.invoke("Volume", "FadeInc")
            assert client.invoke("Volume", "Fade")["value"] == 1

            # unity gain property + action
            assert client.invoke("Volume", "UnityGain")["value"] is False
            mp.volumes.set_unity_gain(True)
            assert client.invoke("Volume", "UnityGain")["value"] is True
            mp.volumes.set_unity_gain(False)

            # per-channel offsets/trims
            client.invoke("Volume", "SetVolumeOffset",
                          channel="Left", value=-2048)
            assert client.invoke("Volume", "VolumeOffset",
                                 channel="Left")["value"] == -2048
            client.invoke("Volume", "SetTrim", channel="Right", value=512)
            assert client.invoke("Volume", "Trim",
                                 channel="Right")["value"] == 512
            with pytest.raises(OdpError) as ei:
                client.invoke("Volume", "VolumeOffset", channel="Sub")
            assert ei.value.code == 816
            with pytest.raises(OdpError) as ei:
                client.invoke("Volume", "SetVolumeOffset",
                              channel="Left", value=10 ** 9)
            assert ei.value.code == 817
            with pytest.raises(OdpError) as ei:
                client.invoke("Volume", "SetTrim",
                              channel="Left", value=10 ** 9)
            assert ei.value.code == 819

            # JSON-evented collections (OffsetsWriterJson/TrimWriterJson)
            svc = next(iter(server._devices.values())).services["Volume"]
            offs = _json.loads(svc.properties()["VolumeOffsets"])
            assert {"channel": "Left", "offset": -2048} in offs
            trims = _json.loads(svc.properties()["Trim"])
            right = [t for t in trims if t["channel"] == "Right"][0]
            assert right["trim"] == 512 and right["min"] < 0 < right["max"]
        finally:
            client.close()
    finally:
        server.close()


def test_odp_volume_offsets_not_supported():
    """A device without offsetter/trims answers 815/818
    (ProviderVolume.cpp:444-452,491-496)."""
    from ohpipeline_jax.av.config import ConfigManager as CM
    from ohpipeline_jax.av.volume import VolumeManager as VM

    class _Mp:
        pass

    from ohpipeline_jax.net.odp import OdpError
    from ohpipeline_jax.net.providers import make_volume_service
    mp = _Mp()
    mp.volumes = VM(CM(), VolumeProfile())
    svc = make_volume_service(mp)
    with pytest.raises(OdpError) as ei:
        svc.invoke("VolumeOffset", {"channel": "Left"})
    assert ei.value.code == 815
    with pytest.raises(OdpError) as ei:
        svc.invoke("SetTrim", {"channel": "Left", "value": 0})
    assert ei.value.code == 818
    assert svc.properties()["VolumeOffsets"] == "[]"
    assert svc.properties()["Trim"] == "[]"


def test_odp_time_and_credentials_services():
    """ProviderTime (TrackCount/Duration/Seconds eventing + the Time
    action, Av/ProviderTime.cpp) and ProviderCredentials (Set/Get/
    Login round-trip with RSA-encrypted wire password, errors 800/801,
    SequenceNumber bump, Ids registration eventing,
    Av/ProviderCredentials.cpp) over the ODP wire."""
    import base64

    from cryptography.hazmat.primitives import serialization
    from cryptography.hazmat.primitives.asymmetric import padding

    from ohpipeline_jax.av.media_player import MediaPlayer
    from ohpipeline_jax.net.odp import OdpClient, OdpError, OdpServer
    from ohpipeline_jax.net.providers import make_device

    mp = MediaPlayer()
    server = OdpServer()
    server.add_device(make_device(mp))
    try:
        client = OdpClient("127.0.0.1", server.port)
        try:
            t = client.invoke("Time", "Time")
            assert (t["TrackCount"], t["Duration"], t["Seconds"]) \
                == (0, 0, 0)

            # credentials: register a consumer, set via the public key
            class Consumer:
                def login(self, user, pw):
                    if (user, pw) != ("alice", b"pw1"):
                        raise RuntimeError("bad creds")
                    return "token-1"

                def re_login(self, current):
                    assert current == "token-1"
                    return "token-2"

            mp.credentials.add("tidal.com", Consumer())
            assert "tidal.com" in \
                client.invoke("Credentials", "GetIds")["value"].split()
            pem = client.invoke("Credentials", "GetPublicKey")["value"]
            pub = serialization.load_pem_public_key(pem.encode())
            blob = pub.encrypt(b"pw1", padding.PKCS1v15())
            seq0 = client.invoke("Credentials", "GetSequenceNumber")["value"]
            client.invoke("Credentials", "Set", Id="tidal.com",
                          userName="alice",
                          password=base64.b64encode(blob).decode())
            assert client.invoke("Credentials",
                                 "GetSequenceNumber")["value"] == seq0 + 1
            got = client.invoke("Credentials", "Get", Id="tidal.com")
            assert got["userName"] == "alice" and got["enabled"] is True
            assert b"pw1" not in base64.b64decode(got["password"])

            # login via the consumer; relogin trades the token
            tok = client.invoke("Credentials", "Login",
                                Id="tidal.com")["token"]
            assert tok == "token-1"
            assert client.invoke("Credentials", "ReLogin", Id="tidal.com",
                                 currentToken=tok)["newToken"] == "token-2"

            # unknown id -> 800; failing consumer -> 801
            with pytest.raises(OdpError) as ei:
                client.invoke("Credentials", "Get", Id="nosuch.com")
            assert ei.value.code == 800
            mp.credentials.set("tidal.com", "alice", b"wrong")
            with pytest.raises(OdpError) as ei:
                client.invoke("Credentials", "Login", Id="tidal.com")
            assert ei.value.code == 801
        finally:
            client.close()
    finally:
        server.close()


def test_odp_volume_error_codes(media_player=None):
    """HelperSetVolume error mapping (ProviderVolume.cpp:573-585): an
    in-range request the limiter pins is swallowed (success, volume
    unchanged); only a request beyond VolumeMax while pinned at max
    surfaces 811; unity-gain mode surfaces 814 for any SetVolume."""
    from ohpipeline_jax.av.media_player import MediaPlayer
    from ohpipeline_jax.net.odp import OdpClient, OdpError, OdpServer
    from ohpipeline_jax.net.providers import make_device

    mp = MediaPlayer()
    server = OdpServer()
    server.add_device(make_device(mp))
    try:
        client = OdpClient("127.0.0.1", server.port)
        try:
            vmax = mp.volumes.profile.max_volume
            limit = mp.volumes.limiter._limit.value
            client.invoke("Volume", "SetVolume", value=limit)
            # pinned at the limit, still below max: swallowed, NOT 811
            client.invoke("Volume", "SetVolume", value=limit + 5)
            assert mp.volumes.volume == limit   # swallowed, unchanged
            # beyond max while pinned at max: 811
            mp.volumes.limiter._limit.set(vmax)
            client.invoke("Volume", "SetVolume", value=vmax)
            with pytest.raises(OdpError) as ei:
                client.invoke("Volume", "SetVolume", value=vmax + 1)
            assert ei.value.code == 811
            mp.volumes.unity.set_unity_gain(True)
            with pytest.raises(OdpError) as ei:
                client.invoke("Volume", "SetVolume", value=10)
            assert ei.value.code == 814
        finally:
            client.close()
    finally:
        server.close()

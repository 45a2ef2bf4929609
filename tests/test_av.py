"""Av-layer tests: config values, volume chain, product/source model,
track database, media-player composition (reference TestConfigManager,
TestVolumeManager, TestTrackDatabase, TestPowerManager, TestMediaPlayer)."""

import numpy as np
import pytest

from ohpipeline_jax.av import (ConfigManager, MediaPlayer,
                               MediaPlayerInitParams, PowerManager, Product,
                               RamStore, Source, TrackDatabase,
                               UriProviderPlaylist, VolumeManager,
                               VolumeProfile)
from ohpipeline_jax.av.config import FileStore, StoreKeyNotFound


class TestConfig:
    def test_num_bounds_and_persistence(self):
        store = RamStore()
        cm = ConfigManager(store)
        v = cm.create_num("Test.Num", 0, 100, 50)
        assert v.value == 50
        v.set(80)
        assert v.value == 80
        with pytest.raises(ValueError):
            v.set(101)
        # new manager over same store restores the persisted value
        cm2 = ConfigManager(store)
        v2 = cm2.create_num("Test.Num", 0, 100, 50)
        assert v2.value == 80

    def test_choice_and_text(self):
        cm = ConfigManager()
        c = cm.create_choice("Test.Choice", {0: "Off", 1: "On"}, 1)
        with pytest.raises(ValueError):
            c.set(7)
        t = cm.create_text("Test.Text", 5, "abc")
        with pytest.raises(ValueError):
            t.set("toolongtext")
        t.set("xy")
        assert t.value == "xy"

    def test_observer_gets_initial_and_changes(self):
        cm = ConfigManager()
        v = cm.create_num("Test.Obs", 0, 10, 3)
        seen = []
        sid = v.subscribe(lambda k, val: seen.append(val))
        v.set(7)
        assert seen == [3, 7]
        v.unsubscribe(sid)
        v.set(9)
        assert seen == [3, 7]

    def test_duplicate_key_rejected(self):
        cm = ConfigManager()
        cm.create_num("K", 0, 1, 0)
        with pytest.raises(ValueError):
            cm.create_num("K", 0, 1, 0)

    def test_file_store_roundtrip(self, tmp_path):
        path = str(tmp_path / "store.json")
        s = FileStore(path)
        s.write("a", b"\x01\x02")
        s.flush()
        s2 = FileStore(path)
        assert s2.read("a") == b"\x01\x02"
        with pytest.raises(StoreKeyNotFound):
            s2.read("missing")


class TestVolume:
    def make(self):
        cm = ConfigManager()
        hw = []
        vm = VolumeManager(cm, VolumeProfile(max_volume=100,
                                             default_volume=40,
                                             default_limit=80),
                           hw=hw.append)
        return vm, hw

    def test_startup_and_set(self):
        vm, hw = self.make()
        assert vm.volume == 40
        vm.set_volume(60)
        assert vm.volume == 60
        assert hw[-1] == 60

    def test_limiter_caps(self):
        vm, hw = self.make()
        vm.set_volume(95)          # above limit 80
        assert vm.volume == 95     # user value kept
        assert hw[-1] == 80        # downstream capped

    def test_out_of_range(self):
        # VolumeUser::SetVolume (VolumeManager.cpp:150-160): a request
        # above max clamps TO max while still below max, and only throws
        # VolumeOutOfRange once already pinned at max
        vm, hw = self.make()
        vm.limiter._limit.set(100)          # take the limiter out of play
        vm.set_volume(101)
        assert vm.volume == 100 and hw[-1] == 100
        with pytest.raises(ValueError):
            vm.set_volume(101)
        with pytest.raises(ValueError):
            vm.set_volume(-1)

    def test_limit_pinned_raise_throws(self):
        # VolumeLimiter::SetVolume (VolumeManager.cpp:229-238): raising
        # the volume further while already pinned at the limit throws —
        # the control point sees error 811, not a silent no-op
        vm, hw = self.make()
        vm.set_volume(80)                   # exactly at limit
        with pytest.raises(ValueError):
            vm.set_volume(90)
        assert vm.volume == 80 and hw[-1] == 80
        # raising the limit afterwards does NOT restore a higher earlier
        # request: the limiter stores the clamped value (DoSetVolume)
        vm.limiter._limit.set(95)
        assert hw[-1] == 80

    def test_unity_gain_volume_not_supported(self):
        # VolumeUnityGainBase::SetVolume throws VolumeNotSupported while
        # unity gain is active (VolumeManager.cpp:408-418)
        from ohpipeline_jax.av.volume import VolumeNotSupported
        vm, hw = self.make()
        vm.set_volume(30)
        vm.unity.set_unity_gain(True)
        assert hw[-1] == 100
        with pytest.raises(VolumeNotSupported):
            vm.set_volume(50)
        vm.unity.set_unity_gain(False)
        assert hw[-1] == 30                 # pre-unity volume restored

    def test_surround_boost(self):
        # VolumeSurroundBoost (VolumeManager.cpp:352-396): signed boost,
        # zero upstream stays silent, negative boost floors at 0
        vm, hw = self.make()
        vm.set_volume(50)
        vm.set_volume_boost(10)
        assert hw[-1] == 60
        vm.set_volume_boost(-60)
        assert hw[-1] == 0
        vm.set_volume(0)
        vm.set_volume_boost(15)
        assert hw[-1] == 0                  # zero upstream stays silent

    def test_mute_reporter_and_standby(self):
        # MuteReporter dedupes + fans out (VolumeManager.cpp:828-868);
        # MuteUser unmutes when leaving standby (VolumeManager.cpp:821-825)
        from ohpipeline_jax.av.config import ConfigManager, RamStore
        from ohpipeline_jax.av.power import PowerManager
        from ohpipeline_jax.av.volume import VolumeManager, VolumeProfile
        store = RamStore()
        power = PowerManager(store)
        hw = []
        vm = VolumeManager(ConfigManager(store),
                           VolumeProfile(default_volume=40),
                           hw.append, power=power)
        seen = []
        vm.add_mute_observer(seen.append)
        assert seen == [False]              # initial state reported
        vm.mute()
        vm.mute()                           # deduped
        assert seen == [False, True] and vm.muted
        power.standby_disable()
        assert not vm.muted and seen[-1] is False

    def test_set_volume_unmutes_no_unmute_does_not(self):
        # VolumeManager::SetVolume unmutes ("OpenHome Volume service is
        # expected to unmute", VolumeManager.cpp:1255-1271);
        # SetVolumeNoUnmute is the same minus the unmute (cpp:1273-1282)
        vm, hw = self.make()
        vm.mute()
        vm.set_volume_no_unmute(50)
        assert vm.muted and hw[-1] == 0
        vm.set_volume(55)
        assert not vm.muted and hw[-1] == 55

    def test_volume_dec_at_zero_noop_keeps_mute(self):
        # ProviderVolume::VolumeDec at 0 answers without touching the
        # chain (ProviderVolume.cpp:305-316) — so it must NOT unmute
        vm, hw = self.make()
        vm.set_volume(0)
        vm.mute()
        vm.volume_dec()
        assert vm.muted and vm.volume == 0
        vm.volume_inc()            # inc at 0 goes through SetVolume
        assert not vm.muted and vm.volume == 1

    def test_unity_gain_observer_and_config_stage(self):
        # VolumeSourceUnityGain observers get an immediate callback and
        # fire on change (VolumeManager.cpp:468-483); the config-driven
        # VolumeUnityGain reads 'Volume.Enabled' once at construction
        # (cpp:440-457)
        vm, hw = self.make()
        seen = []
        vm.add_unity_gain_observer(seen.append)
        assert seen == [False]
        vm.set_unity_gain(True)
        assert seen == [False, True] and vm.unity_gain
        vm.set_unity_gain(False)
        assert seen[-1] is False
        # Volume.Enabled = No fixes the device at unity via the config
        # stage (fresh manager: the value is construction-time)
        import struct
        store = RamStore()
        store.write("Volume.Enabled", struct.pack(">I", 0))
        hw2 = []
        from ohpipeline_jax.av.volume import VolumeNotSupported
        vm2 = VolumeManager(ConfigManager(store),
                            VolumeProfile(max_volume=100),
                            hw=hw2.append)
        assert hw2[-1] == 100      # pinned at unity (= max by default)
        with pytest.raises(VolumeNotSupported):
            vm2.set_volume(30)

    def test_driver_volume_muter(self):
        # VolumeMuter (VolumeManager.cpp:686-720): hard driver mute under
        # the stepped muter; upstream pushes are remembered
        vm, hw = self.make()
        vm.set_volume(60)
        vm.set_volume_muted(True)
        assert hw[-1] == 0
        vm.set_volume(70)          # recorded, not pushed
        assert hw[-1] == 0
        vm.set_volume_muted(False)
        assert hw[-1] == 70

    def test_volume_offsets_and_trims(self):
        from ohpipeline_jax.av.volume import (ChannelInvalid, Trims,
                                              TrimChannelInvalid,
                                              TrimOutOfRange,
                                              VolumeOffsetOutOfRange,
                                              VolumeOffsets)
        store = RamStore()
        cm = ConfigManager(store)
        offs = VolumeOffsets(cm, ("Left", "Right"), offset_max_bmdb=1024)
        trims = Trims(cm, ("Left", "Right"), min_bmdb=-512, max_bmdb=512)
        events = []
        offs.add_observer(lambda o: events.append("offs"))
        trims.add_observer(lambda t: events.append("trims"))
        assert events == ["offs", "trims"]   # immediate callback on add
        offs.set_volume_offset("Left", -300)
        assert offs.get_volume_offset("Left") == -300
        assert events[-1] == "offs"
        trims.set_trim("Right", 256)
        assert trims.get_trim("Right") == 256
        with pytest.raises(ChannelInvalid):
            offs.get_volume_offset("Centre")
        with pytest.raises(VolumeOffsetOutOfRange):
            offs.set_volume_offset("Left", 2048)
        with pytest.raises(TrimChannelInvalid):
            trims.set_trim("Sub", 0)
        with pytest.raises(TrimOutOfRange):
            trims.set_trim("Left", 1000)
        # visitors walk (channel, ...) rows; trims expose channel gains
        rows = []
        trims.visit(lambda ch, lo, hi, t: rows.append((ch, lo, hi, t)))
        assert ("Right", -512, 512, 256) in rows
        gains = trims.channel_multipliers()
        assert gains["Right"] == pytest.approx(10 ** (0.25 / 20))
        # persistence: same store, fresh collections
        offs2 = VolumeOffsets(ConfigManager(store), ("Left", "Right"),
                              offset_max_bmdb=1024)
        assert offs2.get_volume_offset("Left") == -300

    def test_last_used_volume_persists(self):
        # VolumeUser stores the last-used volume and starts from it when
        # startup volume is disabled (ApplyStartupVolume,
        # VolumeManager.cpp:191-206)
        from ohpipeline_jax.av.config import ConfigManager, RamStore
        from ohpipeline_jax.av.volume import VolumeManager, VolumeProfile
        store = RamStore()
        vm = VolumeManager(ConfigManager(store), VolumeProfile())
        vm.user._startup_enabled.set(0)     # startup volume Off
        vm.set_volume(63)
        # same store, fresh manager = reboot
        vm2 = VolumeManager(ConfigManager(store), VolumeProfile())
        assert vm2.volume == 63

    def test_mute_unmute(self):
        vm, hw = self.make()
        vm.set_volume(50)
        vm.mute()
        assert hw[-1] == 0 and vm.muted
        vm.unmute()
        assert hw[-1] == 50 and not vm.muted

    def test_source_offset_never_unmutes_zero(self):
        # VolumeManager.cpp DoSetVolume: user volume 0 forces downstream 0
        # even when the active source carries a positive volume offset.
        vm, hw = self.make()
        vm.offset.set_offset(10)
        vm.set_volume(50)
        assert hw[-1] == 60
        vm.set_volume(0)
        assert hw[-1] == 0
        # and changing the offset while at zero must stay silent
        vm.offset.set_offset(20)
        assert hw[-1] == 0

    def test_inc_dec_and_observer(self):
        vm, _ = self.make()
        seen = []
        vm.add_observer(seen.append)
        vm.volume_inc()
        assert vm.volume == 41
        vm.volume_dec()
        assert seen[-1] == 40

    def test_unity_gain_override(self):
        vm, hw = self.make()
        vm.set_volume(30)
        vm.unity.set_unity_gain(True)
        assert hw[-1] == 100
        vm.unity.set_unity_gain(False)
        assert hw[-1] == 30

    def test_balance_gains(self):
        vm, _ = self.make()
        vm.balance_fade.set_balance(4)
        gl, gr = vm.balance_fade.channel_gains()
        assert gl < 1.0 and gr == 1.0


class TestTrackDatabase:
    def test_insert_order_and_ids(self):
        db = TrackDatabase(max_tracks=5)
        a = db.insert(0, "u1")
        b = db.insert(a, "u2")
        c = db.insert(a, "u3")   # after a -> between a and b
        assert [db.track_by_id(i).uri for i in db.id_array()] == \
            ["u1", "u3", "u2"]
        db.delete(c)
        assert len(db) == 2

    def test_full_raises(self):
        db = TrackDatabase(max_tracks=2)
        db.insert(0, "a")
        db.insert(0, "b")
        with pytest.raises(RuntimeError):
            db.insert(0, "c")

    def test_iteration_with_repeat(self):
        db = TrackDatabase()
        ids = [db.insert(0, f"u{i}") for i in range(3)]
        # insert(0,...) prepends: order is u2,u1,u0
        p = UriProviderPlaylist(db)
        seq = [p.get_next().uri for _ in range(3)]
        assert seq == ["u2", "u1", "u0"]
        assert p.get_next() is None
        p.set_repeat(True)
        p.begin(-1)
        seq2 = [p.get_next().uri for _ in range(4)]
        assert seq2 == ["u2", "u1", "u0", "u2"]

    def test_shuffle_covers_all(self):
        db = TrackDatabase()
        for i in range(10):
            db.insert(0, f"u{i}")
        p = UriProviderPlaylist(db)
        p.set_shuffle(True)
        seen = {p.get_next().uri for _ in range(10)}
        assert len(seen) == 10


class TestProduct:
    def test_source_selection_and_xml(self):
        cm = ConfigManager()
        prod = Product(cm, "Kitchen", "Box")

        class S(Source):
            system_name = "Test"
            type = "Aux"

        s1, s2 = S("One"), S("Two")
        s2.system_name = "Test2"
        prod.add_source(s1)
        prod.add_source(s2)
        prod.start()
        assert prod.source_index() == 0 and s1.active
        prod.set_source_by_name("Test2")
        assert s2.active and not s1.active
        assert "<SystemName>Test2</SystemName>" in prod.source_xml()
        assert prod.room == "Kitchen"

    def test_standby_flow(self):
        cm = ConfigManager()
        prod = Product(cm)

        class S(Source):
            system_name = "X"
            entered = False

            def standby_enabled(self):
                self.entered = True

        s = S()
        prod.add_source(s)
        prod.start()
        assert not prod.standby      # selection leaves standby
        prod.standby_enable()
        assert prod.standby and s.entered


class TestPower:
    def test_power_down_order_and_flush(self, tmp_path):
        store = FileStore(str(tmp_path / "s.json"))
        pm = PowerManager(store)
        order = []
        pm.register_power_handler(10, lambda: order.append("low"))
        pm.register_power_handler(90, lambda: order.append("high"))
        store.write("k", b"v")
        pm.power_down()
        assert order == ["high", "low"]
        assert FileStore(str(tmp_path / "s.json")).read("k") == b"v"


class TestMediaPlayer:
    def test_composition_and_playlist_source(self):
        mp = MediaPlayer(MediaPlayerInitParams(room="Den", name="T"))
        mp.start()
        assert mp.product.source_count() == 2
        assert mp.product.current_source() is mp.source_playlist
        mp.source_playlist.db.insert(0, "tone://sine.wav?duration=1")
        assert len(mp.source_playlist.db) == 1
        # volume wiring reaches the pipeline attenuator (through the limit)
        mp.config.get("Volume.Limit").set(100)
        mp.volumes.set_volume(100)
        assert mp.pipeline.pipeline.attenuator.attenuation == 1 << 14
        mp.volumes.set_volume(50)
        assert mp.pipeline.pipeline.attenuator.attenuation < 1 << 14
        mp.quit()

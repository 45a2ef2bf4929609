"""Service providers: map the MediaPlayer onto ODP services.

Parity target: the reference's Provider* family (ProviderProduct,
ProviderTransport -> PipelineManager Play/Pause/Stop/Seek
(ProviderTransport.cpp:196-216), ProviderVolume -> VolumeManager,
ProviderInfo/Time -> pipeline observers, ProviderPlaylist -> TrackDatabase,
ProviderRadio -> presets, ProviderConfig -> ConfigManager), re-hosted on
the ODP JSON control plane instead of UPnP SOAP.
"""

from __future__ import annotations

import json

from .odp import OdpDevice, OdpError, OdpService


def make_product_service(mp) -> OdpService:
    """The full ProviderProduct surface (Av/ProviderProduct.cpp):
    Manufacturer/Model/Product detail actions backed by the KvpStore,
    Attributes, Source(index)/SourceXmlChangeCount/StandbyTransitioning,
    and source selection by index / display name / system name with the
    reference fault 801 'Source not found' (FaultCode.cpp:21)."""
    svc = OdpService("Product")
    prod = mp.product
    kvp = getattr(mp, "kvp", None)

    def _kvp(key):
        return kvp.get(key) if kvp is not None and kvp.has(key) else ""

    def _select(fn, *args):
        try:
            fn(*args)
        except (IndexError, KeyError):
            raise OdpError(801, "Source not found") from None
        return {}

    svc.add_action("Room", lambda: {"value": prod.room})
    svc.add_action("Name", lambda: {"value": prod.name})
    svc.add_action("Manufacturer", lambda: {
        "Name": _kvp("Manufacturer.Name"),
        "Info": _kvp("Manufacturer.Info"),
        "Url": _kvp("Manufacturer.Url"),
        "ImageUri": _kvp("Manufacturer.ImageUri")})
    svc.add_action("Model", lambda: {
        "Name": _kvp("Model.Name"), "Info": _kvp("Model.Info"),
        "Url": _kvp("Model.Url"), "ImageUri": _kvp("Model.ImageUri")})
    svc.add_action("Product", lambda: {
        "Room": prod.room, "Name": prod.name,
        "Info": _kvp("Product.Info"), "Url": _kvp("Product.Url"),
        "ImageUri": _kvp("Product.ImageUri"),
        "ImageHiresUri": _kvp("Product.ImageHiresUri")})
    svc.add_action("GetImageUri", lambda resolution="": {
        "value": _kvp("Product.ImageHiresUri")
        if resolution == "hires" and _kvp("Product.ImageHiresUri")
        else _kvp("Product.ImageUri")})
    svc.add_action("Attributes", lambda: {"value": prod.attributes})
    svc.add_action("SourceCount", lambda: {"value": prod.source_count()})
    svc.add_action("SourceXml", lambda: {"value": prod.source_xml()})
    svc.add_action("SourceXmlChangeCount",
                   lambda: {"value": prod.source_xml_change_count})
    svc.add_action("SourceIndex", lambda: {"value": prod.source_index()})
    svc.add_action("SetSourceIndex",
                   lambda value: _select(prod.set_source_index, int(value)))
    svc.add_action("SetSourceByName",
                   lambda value: _select(prod.set_source_by_name, value))
    svc.add_action("SetSourceIndexByName",
                   lambda value: _select(prod.set_source_by_name, value))
    svc.add_action("SetSourceBySystemName",
                   lambda value: _select(prod.set_source_by_name, value))

    def _source(index):
        index = int(index)
        if not 0 <= index < prod.source_count():
            raise OdpError(801, "Source not found")
        s = prod.source(index)
        return {"SystemName": s.system_name, "Type": s.type,
                "Name": s.name, "Visible": s.visible}

    svc.add_action("Source", _source)
    svc.add_action("Standby", lambda: {"value": prod.standby})
    svc.add_action("StandbyTransitioning", lambda: {"value": False})
    svc.add_action(
        "SetStandby",
        lambda value: (prod.standby_enable() if value
                       else prod.standby_disable()) or {})

    def update():
        svc.set_property("SourceIndex", prod.source_index())
        svc.set_property("Standby", prod.standby)
        svc.set_property("SourceCount", prod.source_count())
        svc.set_property("SourceXml", prod.source_xml())
        svc.set_property("StandbyTransitioning", False)
        svc.set_property("Attributes", prod.attributes)

    prod.add_observer(update)
    svc.set_property("ProductRoom", prod.room)
    svc.set_property("ProductName", prod.name)
    update()
    return svc


def make_transport_service(mp) -> OdpService:
    """The full ProviderTransport surface (Av/ProviderTransport.cpp):
    Play/Pause/Stop/SkipNext/SkipPrevious with standby-disable on
    play-class actions (cpp:206-293), PlayAs with 'track={json}' command
    parsing (TransportControl.cpp:73-93), Repeat/Shuffle through the
    shared TransportRepeatRandom, SeekSecondAbsolute/Relative with the
    reference error codes (801 action not supported by current mode, 803
    seek failed, 804 stream id not current, cpp:18-23), and the
    ModeInfo/StreamInfo/StreamId/Modes/TransportState query actions over
    evented Can* properties (NotifyMode/NotifyStreamInfo, cpp:133-180)."""
    svc = OdpService("Transport")
    pm = mp.pipeline
    rr = getattr(mp, "transport_repeat_random", None)
    st = {"stream_id": 0, "pos_seconds": 0, "sample_rate": 0,
          "mode_pausable": False}

    def _standby_off():
        # iPowerManager.StandbyDisable(Product) on play-class actions
        if mp.product.standby:
            mp.product.standby_disable()

    def _play():
        _standby_off()
        pm.play()
        return {}

    def _pause():
        # PipelineStreamNotPausable -> Stop (cpp:223-242)
        try:
            pm.pause()
        except Exception:
            pm.stop()
        return {}

    def _skip(backwards):
        _standby_off()
        (pm.prev if backwards else pm.next)()
        return {}

    def _play_as(mode, command=""):
        for i in range(mp.product.source_count()):
            src = mp.product.source(i)
            if src.system_name == mode:
                mp.product.set_source_by_name(src.name)
                break
        else:
            raise OdpError(801, "Action not supported by current mode")
        try:
            pm.play_as(mode, command)
        except ValueError:
            raise OdpError(801,
                           "Action not supported by current mode") from None
        return {}

    def _seek_absolute(streamId, secondAbsolute):
        _standby_off()
        stream_id = int(streamId)
        if stream_id != st["stream_id"] or st["sample_rate"] == 0:
            raise OdpError(804, "Stream id not current")
        if not pm.seek(stream_id, int(secondAbsolute),
                       st["sample_rate"]):
            raise OdpError(803, "Seek failed")
        pm.play()
        return {}

    def _seek_relative(streamId, secondRelative):
        # cpp:341-352: clamp below zero
        seconds = max(0, st["pos_seconds"] + int(secondRelative))
        return _seek_absolute(streamId, seconds)

    svc.add_action("Play", _play)
    svc.add_action("Pause", _pause)
    svc.add_action("Stop", lambda: pm.stop() or {})
    svc.add_action("SkipNext", lambda: _skip(False))
    svc.add_action("SkipPrevious", lambda: _skip(True))
    svc.add_action("PlayAs", _play_as)
    svc.add_action("PlayUri",
                   lambda uri, metadata="": pm.play_uri(uri, metadata) or {})
    if rr is not None:
        svc.add_action("SetRepeat",
                       lambda value: rr.set_repeat(bool(value)) or {})
        svc.add_action("SetShuffle",
                       lambda value: rr.set_random(bool(value)) or {})
        svc.add_action("Repeat", lambda: {"value": rr.repeat})
        svc.add_action("Shuffle", lambda: {"value": rr.random})
        rr.add_observer(lambda repeat, random:
                        (svc.set_property("Repeat", repeat),
                         svc.set_property("Shuffle", random)))
    svc.add_action("SeekSecondAbsolute", _seek_absolute)
    svc.add_action("SeekSecondRelative", _seek_relative)
    svc.add_action("TransportState",
                   lambda: {"value": svc.properties().get(
                       "TransportState", "Stopped")})
    svc.add_action("Modes",
                   lambda: {"value": json.dumps(
                       sorted(pm._providers))})
    svc.add_action("ModeInfo", lambda: {
        "CanSkipNext": svc.properties().get("CanSkipNext", False),
        "CanSkipPrevious": svc.properties().get("CanSkipPrevious", False),
        "CanRepeat": svc.properties().get("CanRepeat", False),
        "CanShuffle": svc.properties().get("CanShuffle", False)})
    svc.add_action("StreamInfo", lambda: {
        "StreamId": st["stream_id"],
        "CanSeek": svc.properties().get("CanSeek", False),
        "CanPause": svc.properties().get("CanPause", False)})
    svc.add_action("StreamId", lambda: {"value": st["stream_id"]})

    class Obs:
        def notify_pipeline_state(self, state):
            # reference wire strings (TransportState::FromPipelineState)
            svc.set_property("TransportState", state.value.title())

        def notify_mode(self, mode, info):
            # NotifyMode (cpp:133-151): capabilities reset per mode
            svc.set_property("CanSkipNext", info.supports_next)
            svc.set_property("CanSkipPrevious", info.supports_prev)
            svc.set_property("CanRepeat", info.supports_repeat)
            svc.set_property("CanShuffle", info.supports_random)
            st["stream_id"] = 0
            st["mode_pausable"] = info.supports_pause
            svc.set_property("StreamId", 0)
            svc.set_property("CanSeek", False)
            svc.set_property("CanPause", False)

        def notify_track(self, track, sos):
            svc.set_property("TrackUri", track.uri)

        def notify_stream_info(self, info):
            # NotifyStreamInfo (cpp:170-180)
            st["stream_id"] = info.stream_id
            st["sample_rate"] = info.sample_rate
            svc.set_property("StreamId", info.stream_id)
            svc.set_property("CanSeek", info.seekable)
            svc.set_property("CanPause",
                             st["mode_pausable"] and not info.live)

        def notify_time(self, seconds, total):
            st["pos_seconds"] = seconds
            svc.set_property("Seconds", seconds)

    pm.add_observer(Obs())
    svc.set_property("TransportState",
                     mp.pipeline.pipeline.state.value.title())
    for prop in ("CanSkipNext", "CanSkipPrevious", "CanRepeat",
                 "CanShuffle", "CanSeek", "CanPause"):
        svc.set_property(prop, False)
    svc.set_property("StreamId", 0)
    return svc


def make_volume_service(mp) -> OdpService:
    """The full ProviderVolume action/property surface
    (Av/ProviderVolume.cpp:181-253) with the reference error codes
    (cpp:15-43): 801 action not supported, 811 volume invalid (only when
    the requested volume exceeds VolumeMax — an in-range request that the
    limiter pins is swallowed, HelperSetVolume cpp:573-585), 812/813
    balance/fade invalid, 814 volume not supported, 815 offsets not
    supported, 816 channel invalid, 817 offset out of range, 818 trim
    not supported, 819 trim out of range."""
    from ..av.volume import (BalanceOutOfRange, ChannelInvalid,
                             FadeOutOfRange, TrimChannelInvalid,
                             TrimOutOfRange, VolumeNotSupported,
                             VolumeOffsetOutOfRange, VolumeOutOfRange)
    svc = OdpService("Volume")
    vm = mp.volumes
    prof = vm.profile

    def _set_volume(value, no_unmute=False, report=True):
        """ProviderVolume::HelperSetVolume[NoUnmute] (cpp:573-602)."""
        value = int(value)
        try:
            if no_unmute:
                vm.set_volume_no_unmute(value)
            else:
                vm.set_volume(value)
        except VolumeOutOfRange:
            # reference volumes are unsigned, so < 0 only exists here;
            # treat it like beyond-max
            if (value > prof.max_volume or value < 0) and report:
                raise OdpError(811, "Volume invalid") from None
        except VolumeNotSupported:
            raise OdpError(814, "Volume not supported") from None
        return {}

    def _inc_dec(delta, no_unmute=False):
        vol = vm.volume
        if delta < 0 and vol == 0:
            return {}                 # VolumeDec at 0 is a no-op
        return _set_volume(vol + delta, no_unmute=no_unmute, report=False)

    svc.add_action("Characteristics", lambda: {
        "VolumeMax": prof.max_volume,
        "VolumeUnity": prof.unity_volume,
        "VolumeSteps": prof.step,
        "VolumeMilliDbPerStep": prof.milli_db_per_step,
        "BalanceMax": prof.balance_max,
        "FadeMax": prof.fade_max})
    svc.add_action("Volume", lambda: {"value": vm.volume})
    svc.add_action("SetVolume", lambda value: _set_volume(value))
    svc.add_action("VolumeInc", lambda: _inc_dec(+prof.step))
    svc.add_action("VolumeDec", lambda: _inc_dec(-prof.step))
    svc.add_action("SetVolumeNoUnmute",
                   lambda value: _set_volume(value, no_unmute=True))
    svc.add_action("VolumeIncNoUnmute",
                   lambda: _inc_dec(+prof.step, no_unmute=True))
    svc.add_action("VolumeDecNoUnmute",
                   lambda: _inc_dec(-prof.step, no_unmute=True))

    def _set_balance(value):
        try:
            vm.balance_fade.set_balance(int(value))
        except BalanceOutOfRange:
            raise OdpError(812, "Balance invalid") from None
        return {}

    def _set_fade(value):
        try:
            vm.balance_fade.set_fade(int(value))
        except FadeOutOfRange:
            raise OdpError(813, "Fade invalid") from None
        return {}

    def _nudge(fn, current, delta):
        try:
            fn(current + delta)      # Inc/Dec ignore out-of-range
        except OdpError as e:
            if e.code not in (812, 813):
                raise
        return {}

    svc.add_action("Balance", lambda: {"value": vm.balance_fade.balance})
    svc.add_action("SetBalance", _set_balance)
    svc.add_action("BalanceInc",
                   lambda: _nudge(_set_balance, vm.balance_fade.balance, 1))
    svc.add_action("BalanceDec",
                   lambda: _nudge(_set_balance, vm.balance_fade.balance, -1))
    svc.add_action("Fade", lambda: {"value": vm.balance_fade.fade})
    svc.add_action("SetFade", _set_fade)
    svc.add_action("FadeInc",
                   lambda: _nudge(_set_fade, vm.balance_fade.fade, 1))
    svc.add_action("FadeDec",
                   lambda: _nudge(_set_fade, vm.balance_fade.fade, -1))

    svc.add_action("Mute", lambda: {"value": vm.muted})
    svc.add_action(
        "SetMute",
        lambda value: (vm.mute() if value else vm.unmute()) or {})
    svc.add_action("VolumeLimit",
                   lambda: {"value": vm.limiter._limit.value})
    svc.add_action("UnityGain", lambda: {"value": vm.unity_gain})
    svc.add_action("VolumeMax",
                   lambda: {"value": prof.max_volume})

    # -- per-channel offsets / trims (errors 815-819) -----------------------
    def _offset_get(channel):
        if vm.offsetter is None:
            raise OdpError(815, "Volume offsets not supported")
        try:
            return {"value": vm.offsetter.get_volume_offset(str(channel))}
        except ChannelInvalid:
            raise OdpError(816, "Channel invalid") from None

    def _offset_set(channel, value):
        if vm.offsetter is None:
            raise OdpError(815, "Volume offsets not supported")
        try:
            vm.offsetter.set_volume_offset(str(channel), int(value))
        except ChannelInvalid:
            raise OdpError(816, "Channel invalid") from None
        except VolumeOffsetOutOfRange:
            raise OdpError(817, "Volume offset out of range") from None
        return {}

    def _trim_get(channel):
        if vm.trims is None:
            raise OdpError(818, "Trim not supported")
        try:
            return {"value": vm.trims.get_trim(str(channel))}
        except TrimChannelInvalid:
            raise OdpError(816, "Channel invalid") from None

    def _trim_set(channel, value):
        if vm.trims is None:
            raise OdpError(818, "Trim not supported")
        try:
            vm.trims.set_trim(str(channel), int(value))
        except TrimChannelInvalid:
            raise OdpError(816, "Channel invalid") from None
        except TrimOutOfRange:
            raise OdpError(819, "Trim out of range") from None
        return {}

    svc.add_action("VolumeOffset", _offset_get)
    svc.add_action("SetVolumeOffset", _offset_set)
    svc.add_action("Trim", _trim_get)
    svc.add_action("SetTrim", _trim_set)

    # -- evented properties (ProviderVolume ctor, cpp:206-253) -------------
    svc.set_property("VolumeMax", prof.max_volume)
    svc.set_property("VolumeUnity", prof.unity_volume)
    svc.set_property("VolumeSteps", prof.step)
    svc.set_property("VolumeMilliDbPerStep", prof.milli_db_per_step)
    svc.set_property("BalanceMax", prof.balance_max)
    svc.set_property("FadeMax", prof.fade_max)
    svc.set_property("VolumeOffsetMax",
                     prof.offset_max * prof.milli_db_per_step)
    svc.set_property("Balance", vm.balance_fade.balance)
    svc.set_property("Fade", vm.balance_fade.fade)
    svc.set_property("VolumeLimit", vm.limiter._limit.value)
    vm.add_observer(lambda v: svc.set_property("Volume", v))
    vm.add_mute_observer(lambda m: svc.set_property("Mute", m))
    vm.add_unity_gain_observer(
        lambda u: svc.set_property("UnityGain", u))
    vm.balance_fade.subscribe_balance(
        lambda k, v: svc.set_property("Balance", v))
    vm.balance_fade.subscribe_fade(
        lambda k, v: svc.set_property("Fade", v))
    vm.limiter._limit.subscribe(
        lambda k, v: svc.set_property("VolumeLimit", v))

    # OffsetsWriterJson / TrimWriterJson analogues (cpp:48-168): the
    # collections event as JSON arrays
    def _offsets_json(offsets):
        rows = []
        offsets.visit(lambda ch, off:
                      rows.append({"channel": ch, "offset": off}))
        svc.set_property("VolumeOffsets", json.dumps(rows))

    def _trims_json(trims):
        rows = []
        trims.visit(lambda ch, lo, hi, trim: rows.append(
            {"channel": ch, "min": lo, "max": hi, "trim": trim}))
        svc.set_property("Trim", json.dumps(rows))

    if vm.offsetter is not None:
        vm.offsetter.add_observer(_offsets_json)
    else:
        svc.set_property("VolumeOffsets", "[]")
    if vm.trims is not None:
        vm.trims.add_observer(_trims_json)
    else:
        svc.set_property("Trim", "[]")
    return svc


def make_info_service(mp) -> OdpService:
    """The full ProviderInfo surface (Av/ProviderInfo.cpp): Counters /
    Track / Details / Metatext actions over the evented
    TrackCount/DetailsCount/MetatextCount and stream detail properties
    (NotifyTrack bumps TrackCount and clears details at start-of-stream,
    cpp:152-167; NotifyStreamInfo fills Details, cpp:187-206)."""
    from ..core.jiffies import Jiffies
    svc = OdpService("Info")

    def _p(name, default=0):
        return svc.properties().get(name, default)

    svc.add_action("Counters", lambda: {
        "TrackCount": _p("TrackCount"),
        "DetailsCount": _p("DetailsCount"),
        "MetatextCount": _p("MetatextCount")})
    svc.add_action("Track", lambda: {
        "Uri": _p("Uri", ""), "Metadata": _p("Metadata", "")})
    svc.add_action("Details", lambda: {
        "Duration": _p("Duration"), "BitRate": _p("BitRate"),
        "BitDepth": _p("BitDepth"), "SampleRate": _p("SampleRate"),
        "Lossless": _p("Lossless", False),
        "CodecName": _p("CodecName", "")})
    svc.add_action("Metatext", lambda: {"value": _p("Metatext", "")})

    class Obs:
        def notify_track(self, track, sos):
            svc.set_property("TrackCount", _p("TrackCount") + 1)
            svc.set_property("Uri", track.uri)
            svc.set_property("Metadata", track.metadata)
            if sos:
                # ClearStreamInfo (cpp:57-71)
                for prop in ("DetailsCount", "Duration", "BitRate",
                             "BitDepth", "SampleRate", "MetatextCount"):
                    svc.set_property(prop, 0)
                svc.set_property("Lossless", False)
                svc.set_property("CodecName", "")
                svc.set_property("Metatext", "")

        def notify_metatext(self, text):
            if _p("Metatext", "") != text:
                svc.set_property("Metatext", text)
                svc.set_property("MetatextCount",
                                 _p("MetatextCount") + 1)

        def notify_stream_info(self, info):
            svc.set_property("DetailsCount", _p("DetailsCount") + 1)
            svc.set_property("SampleRate", info.sample_rate)
            svc.set_property("BitDepth", info.bit_depth)
            svc.set_property("BitRate", info.bitrate)
            svc.set_property("CodecName", info.codec_name)
            svc.set_property("Lossless", info.lossless)
            svc.set_property("Duration", info.track_length_jiffies
                             // Jiffies.kPerSecond)

    mp.pipeline.add_observer(Obs())
    for prop in ("TrackCount", "DetailsCount", "MetatextCount",
                 "Duration", "BitRate", "BitDepth", "SampleRate"):
        svc.set_property(prop, 0)
    svc.set_property("Lossless", False)
    for prop in ("Uri", "Metadata", "CodecName", "Metatext"):
        svc.set_property(prop, "")
    return svc


def _xml_escape(text: str) -> str:
    return (text.replace("&", "&amp;").replace("<", "&lt;")
            .replace(">", "&gt;"))


def _protocol_info(mp) -> str:
    """Supported-protocol string built from the registered protocol
    schemes (the reference assembles it from each protocol's
    ProtocolInfo)."""
    schemes = []
    for p in mp.pipeline.protocol_manager._protocols:
        scheme = getattr(p, "scheme", None) or getattr(p, "name", "")
        if scheme and scheme not in schemes:
            schemes.append(scheme)
    return ",".join(f"{s}:*:*:*" for s in schemes)


def make_playlist_service(mp) -> OdpService:
    """The full ProviderPlaylist surface (Av/Playlist/
    ProviderPlaylist.cpp): transport actions, Insert with 800/801 errors
    (id not found / playlist full, cpp:22-25), Read/ReadList (TrackList
    XML, cpp:324-372), SeekId/SeekIndex (802 index not found),
    IdArray+token / IdArrayChanged, Repeat/Shuffle, TracksMax,
    ProtocolInfo, TransportState."""
    svc = OdpService("Playlist")
    src = mp.source_playlist
    pm = mp.pipeline
    db = src.db

    def _insert(afterId, uri, metadata=""):
        try:
            return {"newId": db.insert(int(afterId), uri, metadata)}
        except RuntimeError:
            raise OdpError(801, "Playlist full") from None
        except KeyError:
            raise OdpError(800, "Id not found") from None

    def _read(id):
        t = db.track_by_id(int(id))
        if t is None:
            raise OdpError(800, "Id not found")
        return {"uri": t.uri, "metadata": t.metadata}

    def _read_list(idList):
        # space-separated ids -> TrackList XML (cpp:324-372); bad or
        # unknown ids are silently skipped
        out = ["<TrackList>"]
        for tok in str(idList).split():
            try:
                t = db.track_by_id(int(tok))
            except ValueError:
                continue
            if t is None:
                continue
            out.append(f"<Entry><Id>{t.id}</Id>"
                       f"<Uri>{_xml_escape(t.uri)}</Uri>"
                       f"<Metadata>{_xml_escape(t.metadata)}</Metadata>"
                       "</Entry>")
        out.append("</TrackList>")
        return {"value": "".join(out)}

    def _seek_index(value):
        ids = db.id_array()
        index = int(value)
        if not 0 <= index < len(ids):
            raise OdpError(802, "Index not found")
        src.seek_id(ids[index])
        return {}

    svc.add_action("Play", lambda: pm.play() or {})
    svc.add_action("Pause", lambda: pm.pause() or {})
    svc.add_action("Stop", lambda: pm.stop() or {})
    svc.add_action("Next", lambda: pm.next() or {})
    svc.add_action("Previous", lambda: pm.prev() or {})
    svc.add_action("Insert", _insert)
    svc.add_action("DeleteId", lambda value: db.delete(int(value)) or {})
    svc.add_action("DeleteAll", lambda: db.delete_all() or {})
    svc.add_action("IdArray",
                   lambda: {"token": db.seq, "array": db.id_array()})
    svc.add_action("IdArrayChanged",
                   lambda token: {"value": int(token) != db.seq})
    svc.add_action("Read", _read)
    svc.add_action("ReadList", _read_list)
    svc.add_action("SeekId", lambda value: src.seek_id(int(value)) or {})
    svc.add_action("SeekIndex", _seek_index)
    svc.add_action("TracksMax", lambda: {"value": db.max_tracks})
    svc.add_action("ProtocolInfo",
                   lambda: {"value": _protocol_info(mp)})
    svc.add_action(
        "SetRepeat",
        lambda value: src.provider.set_repeat(bool(value)) or {})
    svc.add_action(
        "SetShuffle",
        lambda value: src.provider.set_shuffle(bool(value)) or {})
    svc.add_action("Repeat", lambda: {"value": src.provider.repeat})
    svc.add_action("Shuffle", lambda: {"value": src.provider.shuffle})
    svc.add_action("TransportState",
                   lambda: {"value": svc.properties().get(
                       "TransportState", "Stopped")})

    class Obs:
        def notify_pipeline_state(self, state):
            svc.set_property("TransportState", state.value.title())

        def notify_track(self, track, sos):
            svc.set_property("Id", track.id)

    pm.add_observer(Obs())

    def _db_changed():
        svc.set_property("IdArraySeq", db.seq)
        svc.set_property("IdArray", db.id_array())

    db.add_observer(_db_changed)
    svc.set_property("TransportState", "Stopped")
    svc.set_property("Id", 0)
    svc.set_property("TracksMax", db.max_tracks)
    svc.set_property("ProtocolInfo", _protocol_info(mp))
    _db_changed()
    return svc


def make_radio_service(mp) -> OdpService:
    """The full ProviderRadio surface (Av/Radio/ProviderRadio.cpp):
    Play/Pause/Stop, Channel/SetChannel (the directly-tuned station),
    Id/SetId (preset selection by id, 800 'Id not found', cpp:23-24),
    Read/ReadList, IdArray+token / IdArrayChanged, ChannelsMax,
    ProtocolInfo, TransportState."""
    svc = OdpService("Radio")
    src = mp.source_radio
    pm = mp.pipeline
    presets = src.presets
    state = {"channel_uri": "", "channel_metadata": "", "id": 0}

    def _preset_by_id(preset_id):
        for i in range(presets.max_presets):
            p = presets.preset(i)
            if p is not None and p.id == int(preset_id):
                return p
        raise OdpError(800, "Id not found")

    def _set_id(value, uri=""):
        p = _preset_by_id(value)
        state["id"] = p.id
        state["channel_uri"] = p.uri
        state["channel_metadata"] = p.metadata
        svc.set_property("Id", p.id)
        src.provider.set_station(p.uri, p.metadata, p.id)
        pm.begin("Radio")
        return {}

    def _set_channel(uri, metadata=""):
        state["id"] = 0
        state["channel_uri"] = uri
        state["channel_metadata"] = metadata
        svc.set_property("Id", 0)
        svc.set_property("Uri", uri)
        svc.set_property("Metadata", metadata)
        src.provider.set_station(uri, metadata)
        pm.begin("Radio")
        return {}

    def _read(id):
        p = _preset_by_id(id)
        return {"metadata": p.metadata}

    def _read_list(idList):
        # ChannelList XML, same silent-skip rules as the playlist
        out = ["<ChannelList>"]
        for tok in str(idList).split():
            try:
                p = _preset_by_id(int(tok))
            except (ValueError, OdpError):
                continue
            out.append(f"<Entry><Id>{p.id}</Id>"
                       f"<Uri>{_xml_escape(p.uri)}</Uri>"
                       f"<Metadata>{_xml_escape(p.metadata)}</Metadata>"
                       "</Entry>")
        out.append("</ChannelList>")
        return {"value": "".join(out)}

    svc.add_action("Play", lambda: pm.play() or {})
    svc.add_action("Pause", lambda: pm.pause() or {})
    svc.add_action("Stop", lambda: pm.stop() or {})
    svc.add_action(
        "SetPreset",
        lambda index, uri, metadata="":
        presets.set_preset(int(index), uri, metadata) or {})
    svc.add_action("Channel", lambda: {
        "uri": state["channel_uri"],
        "metadata": state["channel_metadata"]})
    svc.add_action("SetChannel", _set_channel)
    svc.add_action("Id", lambda: {"value": state["id"]})
    svc.add_action("SetId", _set_id)
    svc.add_action("Read", _read)
    svc.add_action("ReadList", _read_list)
    svc.add_action("IdArray",
                   lambda: {"token": presets.seq,
                            "array": presets.id_array()})
    svc.add_action("IdArrayChanged",
                   lambda token: {"value": int(token) != presets.seq})
    svc.add_action("ChannelsMax",
                   lambda: {"value": presets.max_presets})
    svc.add_action("ProtocolInfo",
                   lambda: {"value": _protocol_info(mp)})
    svc.add_action("TransportState",
                   lambda: {"value": svc.properties().get(
                       "TransportState", "Stopped")})
    svc.add_action("PlayPreset",
                   lambda index: src.play_preset(int(index)) or {})
    svc.add_action("PlayUri",
                   lambda uri, metadata="": src.play_uri(uri, metadata) or {})

    class Obs:
        def notify_pipeline_state(self, state_):
            svc.set_property("TransportState", state_.value.title())

    pm.add_observer(Obs())
    svc.set_property("TransportState", "Stopped")
    svc.set_property("Id", 0)
    svc.set_property("ChannelsMax", presets.max_presets)
    svc.set_property("ProtocolInfo", _protocol_info(mp))
    return svc


def make_config_service(mp) -> OdpService:
    svc = OdpService("Config")
    cm = mp.config
    svc.add_action("Keys", lambda: {"keys": cm.keys()})
    svc.add_action("Get", lambda key: {"value": cm.get(key).value})
    svc.add_action("Set", lambda key, value: cm.get(key).set(value) or {})
    return svc


def make_reaction_service(mp) -> OdpService:
    """Reaction service (reference Av/ProviderReaction.cpp): attach a
    reaction to the currently playing track via the registered
    handlers; properties mirror CanReact/CurrentReaction/
    AvailableReactions."""
    from ..av.reactions import ReactionError
    svc = OdpService("Reaction")
    reg = mp.reactions

    def _sync():
        svc.set_property("CanReact", reg.can_react)
        svc.set_property("CurrentReaction", reg.current_reaction)
        svc.set_property("AvailableReactions", reg.available_reactions)

    def _wrap(fn, *a):
        try:
            fn(*a)
        except ReactionError as e:
            return {"error": e.code, "message": str(e)}
        return {}

    svc.add_action("GetCanReact", lambda: {"value": reg.can_react})
    svc.add_action("GetCurrentReaction",
                   lambda: {"value": reg.current_reaction})
    svc.add_action("GetAvailableReactions",
                   lambda: {"value": reg.available_reactions})
    svc.add_action("SetReaction",
                   lambda reaction: _wrap(reg.set_reaction, reaction))
    svc.add_action("ClearReaction", lambda: _wrap(reg.clear_reaction))

    class Obs:
        def notify_track(self, track, sos):
            reg.notify_track(track, sos)

    mp.pipeline.add_observer(Obs())
    reg.add_observer(_sync)
    _sync()
    return svc


def make_time_service(mp) -> OdpService:
    """ProviderTime (Av/ProviderTime.cpp:14-97): TrackCount increments
    per track, Duration/Seconds follow the pipeline time observer, a
    stop resets Seconds to 0, and the Time action answers all three."""
    svc = OdpService("Time")
    svc.set_property("TrackCount", 0)
    svc.set_property("Duration", 0)
    svc.set_property("Seconds", 0)

    class Obs:
        def notify_track(self, track, sos):
            svc.set_property(
                "TrackCount", int(svc.properties()["TrackCount"]) + 1)

        def notify_time(self, seconds, total):
            svc.set_property("Duration", int(total))
            svc.set_property("Seconds", int(seconds))

        def notify_pipeline_state(self, state):
            if getattr(state, "value", str(state)) == "stopped":
                svc.set_property("Seconds", 0)

    mp.pipeline.add_observer(Obs())
    svc.add_action("Time", lambda: {
        "TrackCount": svc.properties()["TrackCount"],
        "Duration": svc.properties()["Duration"],
        "Seconds": svc.properties()["Seconds"]})
    return svc


def make_credentials_service(mp) -> OdpService:
    """ProviderCredentials (Av/ProviderCredentials.cpp:12-230): Set/
    Clear/SetEnabled/Get/Login/ReLogin/GetIds/GetPublicKey/
    GetSequenceNumber with the reference error codes 800 'Id not
    found', 801 'Login failed', 802 'Username or password too long';
    Ids is the space-separated registered list, SequenceNumber bumps
    on every credentials change."""
    import base64

    from ..av.credentials import (CredentialsIdNotFound,
                                  CredentialsLoginFailed,
                                  CredentialsTooLong)
    svc = OdpService("Credentials")
    creds = mp.credentials

    def _ids() -> str:
        return " ".join(creds.ids())

    svc.set_property("Ids", _ids())
    svc.set_property("PublicKey", creds.public_key_pem())
    svc.set_property("SequenceNumber", 0)

    def _bump():
        svc.set_property(
            "SequenceNumber",
            int(svc.properties()["SequenceNumber"]) + 1)

    def _wrap(fn):
        def wrapped(**kw):
            try:
                return fn(**kw)
            except CredentialsIdNotFound:
                raise OdpError(800, "Id not found") from None
            except CredentialsLoginFailed:
                raise OdpError(801, "Login failed") from None
            except CredentialsTooLong:
                raise OdpError(
                    802, "Username or password too long") from None
        return wrapped

    def _set(Id, userName, password):
        # the wire carries the RSA-encrypted password base64-coded (the
        # reference's binary argument)
        creds.set(str(Id), str(userName),
                  base64.b64decode(password) if isinstance(password, str)
                  else bytes(password))
        _bump()
        return {}

    def _clear(Id):
        creds.clear(str(Id))
        _bump()
        return {}

    def _set_enabled(Id, enabled):
        creds.set_enabled(str(Id), bool(enabled))
        _bump()
        return {}

    def _get(Id):
        sid = str(Id)
        user, _pw = creds.get(sid)
        # the reference answers the ENCRYPTED password blob — plaintext
        # never crosses the wire (ProviderCredentials::Get)
        try:
            blob = mp.store.read(f"Credentials.{sid}.Password")
        except Exception:             # noqa: BLE001 — no password stored
            blob = b""
        return {"userName": user,
                "password": base64.b64encode(blob).decode(),
                "enabled": creds.enabled(sid),
                "status": creds.status(sid),
                "data": ""}

    svc.add_action("Set", _wrap(_set))
    svc.add_action("Clear", _wrap(_clear))
    svc.add_action("SetEnabled", _wrap(_set_enabled))
    svc.add_action("Get", _wrap(_get))
    svc.add_action("Login",
                   _wrap(lambda Id: {"token": creds.login(str(Id))}))
    svc.add_action(
        "ReLogin",
        _wrap(lambda Id, currentToken:
              {"newToken": creds.re_login(str(Id), str(currentToken))}))
    svc.add_action("GetIds", lambda: {"value": _ids()})
    svc.add_action("GetPublicKey",
                   lambda: {"value": creds.public_key_pem()})
    svc.add_action(
        "GetSequenceNumber",
        lambda: {"value": svc.properties()["SequenceNumber"]})

    # keep the Ids property fresh when services register later
    creds.add_register_observer(
        lambda: svc.set_property("Ids", _ids()))
    return svc


def make_oauth_service(mp) -> OdpService:
    """ProviderOAuth (Av/ProviderOAuth.cpp): token upload rides the wire
    encrypted — the AES-128 key and init vector RSA-OAEP-encrypted to
    the device's public key, the refresh token AES-CBC-encrypted with a
    big-endian uint16 content-length prefix (AESHelpers.cpp:16-40).
    Error codes (cpp:199-223): 800 service id not found, 801 token
    invalid, 802 parameter invalid, 803 decryption failed, 804 token id
    not found, 805 polling jobs at capacity, 806 polling request
    failed, 807 token id invalid/too big."""
    import base64
    import json as _json

    svc = OdpService("OAuth")
    reg = mp.oauth

    def _b64(arg) -> bytes:
        return base64.b64decode(arg) if isinstance(arg, str) \
            else bytes(arg)

    def _svc_or_800(service_id):
        slot = reg.service(str(service_id))
        if slot is None:
            raise OdpError(800, "Service id not found")
        return slot

    svc.add_action("GetPublicKey",
                   lambda: {"value": mp.credentials.public_key_pem()})

    def _set_token(ServiceId, TokenId, AesKeyRsaEncrypted,
                   InitVectorRsaEncrypted, TokenAesEncrypted,
                   IsLongLived=False):
        from cryptography.hazmat.primitives import hashes
        from cryptography.hazmat.primitives.asymmetric import padding
        from cryptography.hazmat.primitives.ciphers import (Cipher,
                                                            algorithms,
                                                            modes)
        for name, arg in (("TokenId", TokenId),
                          ("AesKey", AesKeyRsaEncrypted),
                          ("InitVector", InitVectorRsaEncrypted),
                          ("Token", TokenAesEncrypted)):
            if not arg:
                raise OdpError(802, f"Parameter {name} invalid")
        slot = _svc_or_800(ServiceId)
        oaep = padding.OAEP(mgf=padding.MGF1(hashes.SHA1()),
                            algorithm=hashes.SHA1(), label=None)
        try:
            key = mp.credentials._key.decrypt(_b64(AesKeyRsaEncrypted),
                                              oaep)
            iv = mp.credentials._key.decrypt(
                _b64(InitVectorRsaEncrypted), oaep)
            dec = Cipher(algorithms.AES(key[:16]),
                         modes.CBC(iv[:16])).decryptor()
            plain = dec.update(_b64(TokenAesEncrypted)) + dec.finalize()
            n = int.from_bytes(plain[:2], "big")
            if n > len(plain) - 2:
                raise ValueError("bad content length")
            refresh = plain[2:2 + n].decode()
        except OdpError:
            raise
        except Exception:             # noqa: BLE001 — wire-crypto failure
            raise OdpError(803, "Decryption failed") from None
        if len(str(TokenId)) > 128:
            raise OdpError(807, "Token source too big")
        try:
            slot["tokens"].add_token(str(TokenId), refresh,
                                     long_lived=bool(IsLongLived))
        except RuntimeError:
            raise OdpError(801, "Token invalid") from None
        return {}

    svc.add_action("SetToken", _set_token)

    def _clear(ServiceId, TokenId, long_lived=None):
        slot = _svc_or_800(ServiceId)
        tm = slot["tokens"]
        tid = str(TokenId)
        match = [i for i in tm.token_ids() if i == tid
                 and (long_lived is None
                      or tm._tokens[i].long_lived == long_lived)]
        if not match:
            raise OdpError(804, "Token id not found")
        tm.remove_token(tid)
        return {}

    svc.add_action("ClearToken",
                   lambda ServiceId, TokenId: _clear(ServiceId, TokenId))
    svc.add_action(
        "ClearShortLivedToken",
        lambda ServiceId, TokenId: _clear(ServiceId, TokenId, False))
    svc.add_action(
        "ClearLongLivedToken",
        lambda ServiceId, TokenId: _clear(ServiceId, TokenId, True))

    def _clear_many(ServiceId, want):
        slot = _svc_or_800(ServiceId)
        tm = slot["tokens"]
        for tid in tm.token_ids():
            if want is None or tm._tokens[tid].long_lived == want:
                tm.remove_token(tid)
        return {}

    svc.add_action("ClearShortLivedTokens",
                   lambda ServiceId: _clear_many(ServiceId, False))
    svc.add_action("ClearLongLivedTokens",
                   lambda ServiceId: _clear_many(ServiceId, True))
    svc.add_action("ClearAllTokens",
                   lambda ServiceId: _clear_many(ServiceId, None))

    svc.add_action("GetUpdateId", lambda: {"value": reg.update_id})
    svc.add_action("GetJobUpdateId",
                   lambda: {"value": reg.job_update_id})
    svc.add_action("GetServiceStatus",
                   lambda: {"value": _json.dumps(reg.service_status())})
    svc.add_action("GetJobStatus",
                   lambda: {"value": _json.dumps(reg.job_status())})
    svc.add_action("GetSupportedServices", lambda: {
        "value": _json.dumps([{"id": sid} for sid in reg.service_ids()])})

    def _begin_flow(ServiceId):
        slot = _svc_or_800(ServiceId)
        if reg.running_jobs(str(ServiceId)) >= slot["max_jobs"]:
            raise OdpError(805, "Polling jobs at capacity")
        try:
            job = reg.begin_limited_input_flow(str(ServiceId))
        except OdpError:
            raise
        except Exception:             # noqa: BLE001 — flow start failed
            raise OdpError(806, "Polling request failed") from None
        return {"JobId": job.job_id,
                "LoginUrl": job.request.verification_url,
                "UserCode": job.request.user_code}

    svc.add_action("BeginLimitedInputFlow", _begin_flow)

    svc.set_property("PublicKey", mp.credentials.public_key_pem())
    svc.set_property("UpdateId", 0)
    svc.set_property("JobUpdateId", 0)
    svc.set_property("SupportedServices", _json.dumps([]))

    def _sync():
        svc.set_property("UpdateId", reg.update_id)
        svc.set_property("SupportedServices", _json.dumps(
            [{"id": sid} for sid in reg.service_ids()]))

    reg.add_observer(_sync)
    reg.add_job_observer(
        lambda: svc.set_property("JobUpdateId", reg.job_update_id))
    return svc


def make_debug_service(mp) -> OdpService:
    """Debug service (reference ProviderDebug,
    OpenHome/Av/ProviderDebug.h:48-63 over Debug2): ring-buffer log
    dump, log upload through the ILogPoster hook, SSDP re-announce and
    the recent-M-SEARCH observer list; plus a LogBuffers action
    reporting pipeline reservoir occupancy (the reference exposes the
    same numbers through its Shell 'pipeline' command)."""
    import json as _json

    svc = OdpService("Debug")
    svc.add_action("GetLog", lambda: {"value": mp.log.dump()})

    def send_log(data=""):
        if mp.log_poster is None:
            raise RuntimeError("no log poster configured")
        mp.log_poster(mp.log.dump(), data)
        return {}

    svc.add_action("SendLog", send_log)

    def announce():
        for r in mp.ssdp_responders:
            r.notify_alive()
        return {}

    svc.add_action("SendDeviceAnnouncements", announce)

    def msearches():
        out = []
        for r in mp.ssdp_responders:
            out += [{"address": a, "seconds_ago": s}
                    for a, s in r.recent_msearches()]
        return {"value": _json.dumps(out)}

    svc.add_action("GetRecentMSearches", msearches)

    def log_buffers():
        pipe = mp.pipeline.pipeline     # PipelineManager -> Pipeline
        return {"encoded_bytes": pipe.encoded.occupancy,
                "decoded_jiffies": pipe.decoded.occupancy}

    svc.add_action("LogBuffers", log_buffers)
    return svc


def make_pins_service(mp) -> OdpService:
    """Pins service (Av/Pins/ProviderPins.cpp): the full action table
    (GetDeviceMax/GetAccountMax/GetModes/GetIdArray/GetCloudConnected/
    ReadList/InvokeId/InvokeIndex/InvokeUri/SetDevice/SetAccount/Clear/
    Swap) with the reference error mapping (cpp:19-30): 801 index out of
    range, 802 id not found, 803 mode not supported, 804 login required,
    805 nothing to play, 806 uri not supported.  DeviceMax/AccountMax/
    Modes/IdArray/CloudConnected are evented."""
    from ..av.credentials import CredentialsLoginFailed
    from ..av.pins import (PinIdNotFound, PinIndexOutOfRange,
                           PinModeNotSupported, PinNothingToPlay,
                           PinUriError)
    svc = OdpService("Pins")
    pins = mp.pins

    def guard(fn):
        """Map the typed pin failures onto the wire codes
        (ProviderPins.cpp:212-345)."""
        def run(*a, **kw):
            try:
                return fn(*a, **kw) or {}
            except PinIndexOutOfRange:
                raise OdpError(801, "Pin index out of range") from None
            except PinIdNotFound:
                raise OdpError(802, "Pin id not found") from None
            except PinModeNotSupported:
                raise OdpError(803, "Pin mode not supported") from None
            except CredentialsLoginFailed:
                raise OdpError(804, "Login required") from None
            except PinNothingToPlay:
                raise OdpError(805, "Nothing to Play") from None
            except PinUriError:
                raise OdpError(806, "Pin uri not supported") from None
        return run

    svc.add_action("GetDeviceMax", lambda: {"value": pins.device_max})
    svc.add_action("GetAccountMax", lambda: {"value": pins.account_max})
    svc.add_action("GetModes", lambda: {"value": json.dumps(pins.modes())})
    svc.add_action("GetIdArray",
                   lambda: {"value": json.dumps(pins.id_array())})
    svc.add_action("GetCloudConnected", lambda: {"value": False})
    svc.add_action(
        "ReadList",
        lambda ids: {"value": pins.write_json(json.loads(ids))})
    svc.add_action("InvokeId",
                   guard(lambda id: pins.invoke_id(int(id))))
    svc.add_action("InvokeIndex",
                   guard(lambda index: pins.invoke_index(int(index))))
    svc.add_action(
        "InvokeUri",
        guard(lambda mode, type="", uri="", shuffle=False:
              pins.invoke_uri(mode, type, uri, bool(shuffle))))
    svc.add_action(
        "SetDevice",
        guard(lambda index, mode, type="", uri="", title="",
              description="", artworkUri="", shuffle=False:
              pins.set(int(index), mode, type, uri, title, description,
                       artworkUri, bool(shuffle))))
    svc.add_action(
        "SetAccount",
        guard(lambda index, **kw: (_ for _ in ()).throw(
            PinIndexOutOfRange(index))))   # account set not wired (max 0)
    svc.add_action("Clear", guard(lambda id: pins.clear(int(id))))
    svc.add_action(
        "Swap",
        guard(lambda index1, index2: pins.swap(int(index1), int(index2))))

    def update(_index=None):
        svc.set_property("IdArray", json.dumps(pins.id_array()))
        svc.set_property("Modes", json.dumps(pins.modes()))

    pins.add_observer(update)
    svc.set_property("DeviceMax", pins.device_max)
    svc.set_property("AccountMax", pins.account_max)
    svc.set_property("CloudConnected", False)
    update()
    return svc


def make_receiver_service(mp, source=None) -> OdpService:
    """Receiver service (Av/Songcast/ProviderReceiver.cpp): Play / Stop /
    SetSender / Sender / ProtocolInfo / TransportState actions over the
    Songcast receiver source, with evented Uri / Metadata /
    TransportState / ProtocolInfo.  A bad sender URI maps to error 800
    'Invalid sender uri' (cpp:15-16, 63-70)."""
    from ..av.receiver_sources import SourceReceiver, UriError
    if source is None:
        source = next(s for s in mp.product._sources
                      if isinstance(s, SourceReceiver))
    svc = OdpService("Receiver")

    def set_sender(uri, metadata=""):
        try:
            source.set_sender(uri, metadata)
        except UriError:
            raise OdpError(800, "Invalid sender uri")
        svc.set_property("Uri", uri)
        svc.set_property("Metadata", metadata)
        return {}

    svc.add_action("Play", lambda: source.play() or {})
    svc.add_action("Stop", lambda: source.stop() or {})
    svc.add_action("SetSender", set_sender)

    def sender():
        uri, metadata = source.sender_info()
        return {"Uri": uri, "Metadata": metadata}

    svc.add_action("Sender", sender)
    svc.add_action("ProtocolInfo",
                   lambda: {"value": source.PROTOCOL_INFO})
    svc.add_action("TransportState",
                   lambda: {"value": svc.properties().get(
                       "TransportState", "Stopped")})

    class Obs:
        def notify_pipeline_state(self, state):
            # TransportState::FromPipelineState (PipelineObserver.cpp:13)
            svc.set_property("TransportState",
                             getattr(state, "value", str(state)).title())

    mp.pipeline.add_observer(Obs())
    uri, metadata = source.sender_info()
    svc.set_property("Uri", uri)
    svc.set_property("Metadata", metadata)
    svc.set_property("TransportState", "Stopped")
    svc.set_property("ProtocolInfo", source.PROTOCOL_INFO)
    return svc


def make_sender_service(mp, sender=None) -> OdpService:
    """Sender service (ProviderSender, Av/Songcast/OhmSender.cpp:84-293):
    PresentationUrl / Metadata / Audio / Status / Status2 / Enabled /
    Attributes, all evented, fed by the SongcastSender status machine."""
    sender = sender if sender is not None else mp.sender
    svc = OdpService("Sender")
    st = sender.provider

    svc.add_action("PresentationUrl",
                   lambda: {"value": st.presentation_url})
    svc.add_action("Metadata", lambda: {"value": st.metadata})
    svc.add_action("Audio",
                   lambda: {"value": bool(svc.properties().get("Audio",
                                                               False))})
    svc.add_action("Status", lambda: {"value": st.status})
    svc.add_action("Status2", lambda: {"value": st.status2})
    svc.add_action("Enabled",
                   lambda: {"value": st.status == "Enabled"})
    svc.add_action("Attributes", lambda: {"value": st.attributes})

    st.add_observer(svc.set_property)
    svc.set_property("PresentationUrl", st.presentation_url)
    svc.set_property("Metadata", st.metadata)
    svc.set_property("Audio", False)
    svc.set_property("Status", st.status)
    svc.set_property("Status2", st.status2)
    svc.set_property("Enabled", st.status == "Enabled")
    svc.set_property("Attributes", st.attributes)

    class Obs:
        def notify_pipeline_state(self, state):
            sender.notify_pipeline_state(state)

    mp.pipeline.add_observer(Obs())
    return svc


def make_device(mp, udn: str = "ohpipeline-jax-1") -> OdpDevice:
    """Build the full ODP device for a MediaPlayer (the reference's
    DvDeviceStandard + provider registration in MediaPlayer.cpp).
    Receiver/Sender services register when the MediaPlayer has the
    Songcast receiver source / a SongcastSender (the reference registers
    them from SourceReceiver's ctor, SourceReceiver.cpp:218/236)."""
    dev = OdpDevice(udn, mp.product.name, "av.openhome.org:media")
    for factory in (make_product_service, make_transport_service,
                    make_volume_service, make_info_service,
                    make_time_service, make_credentials_service,
                    make_oauth_service,
                    make_playlist_service, make_radio_service,
                    make_config_service, make_reaction_service,
                    make_debug_service, make_pins_service):
        svc = factory(mp)
        dev.add_service(svc)
        # each provider registers its presence on the product attribute
        # string (Product::AddAttribute, MediaPlayer.cpp:222-253)
        mp.product.add_attribute(svc.name)
    from ..av.receiver_sources import SourceReceiver
    if any(isinstance(s, SourceReceiver) for s in mp.product._sources):
        dev.add_service(make_receiver_service(mp))
        mp.product.add_attribute("Receiver")
    if getattr(mp, "sender", None) is not None:
        dev.add_service(make_sender_service(mp))
        mp.product.add_attribute("Sender")
    return dev

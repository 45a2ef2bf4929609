"""Small Av-layer components: DIDL-Lite metadata, static device data,
mute manager, mime-type list, friendly-name manager, repeat/random state.

Parity targets: OpenHome/Av/OhMetadata.* (DIDL-Lite builder/parser),
KvpStore.* (read-only device data), Media/MuteManager.*,
Media/MimeTypeList.*, Av/FriendlyNameManager.*, Av/TransportControl
(TransportRepeatRandom).
"""

from __future__ import annotations

import threading
import xml.etree.ElementTree as ET
from dataclasses import dataclass, field
from typing import Callable, Optional
from xml.sax.saxutils import escape

DIDL_NS = "urn:schemas-upnp-org:metadata-1-0/DIDL-Lite/"
UPNP_NS = "urn:schemas-upnp-org:metadata-1-0/upnp/"
DC_NS = "http://purl.org/dc/elements/1.1/"


@dataclass(slots=True)
class TrackMetadata:
    """Parsed DIDL-Lite item (OhMetadata.cpp's media-metadata model)."""
    title: str = ""
    artist: str = ""
    album: str = ""
    genre: str = ""
    artwork_uri: str = ""
    duration_s: int = 0
    bitrate: int = 0
    uri: str = ""


def didl_lite(md: TrackMetadata) -> str:
    """Build a DIDL-Lite document (OhMetadata::ToDidlLite)."""
    res_attrs = ""
    if md.duration_s:
        h, rem = divmod(md.duration_s, 3600)
        m, s = divmod(rem, 60)
        res_attrs += f' duration="{h}:{m:02d}:{s:02d}.000"'
    if md.bitrate:
        res_attrs += f' bitrate="{md.bitrate // 8}"'
    parts = [f'<DIDL-Lite xmlns="{DIDL_NS}" xmlns:dc="{DC_NS}" '
             f'xmlns:upnp="{UPNP_NS}">',
             '<item id="0" parentID="0" restricted="True">']
    if md.title:
        parts.append(f"<dc:title>{escape(md.title)}</dc:title>")
    if md.artist:
        parts.append(f"<upnp:artist>{escape(md.artist)}</upnp:artist>")
    if md.album:
        parts.append(f"<upnp:album>{escape(md.album)}</upnp:album>")
    if md.genre:
        parts.append(f"<upnp:genre>{escape(md.genre)}</upnp:genre>")
    if md.artwork_uri:
        parts.append("<upnp:albumArtURI>"
                     f"{escape(md.artwork_uri)}</upnp:albumArtURI>")
    if md.uri:
        parts.append(f"<res{res_attrs}>{escape(md.uri)}</res>")
    parts.append("<upnp:class>object.item.audioItem.musicTrack"
                 "</upnp:class></item></DIDL-Lite>")
    return "".join(parts)


def parse_didl_lite(xml_text: str) -> TrackMetadata:
    """Parse a DIDL-Lite document (OhMetadata's parser; tolerant)."""
    md = TrackMetadata()
    if not xml_text:
        return md
    try:
        root = ET.fromstring(xml_text)
    except ET.ParseError:
        return md

    def tag(t):
        return t.rsplit("}", 1)[-1]

    for el in root.iter():
        t = tag(el.tag)
        text = (el.text or "").strip()
        if t == "title":
            md.title = text
        elif t == "artist" and not md.artist:
            md.artist = text
        elif t == "album":
            md.album = text
        elif t == "genre":
            md.genre = text
        elif t == "albumArtURI":
            md.artwork_uri = text
        elif t == "res":
            md.uri = text
            dur = el.get("duration", "")
            if dur:
                try:
                    h, m, s = dur.split(":")
                    md.duration_s = (int(h) * 3600 + int(m) * 60
                                     + int(float(s)))
                except ValueError:
                    pass
            if el.get("bitrate"):
                try:
                    md.bitrate = int(el.get("bitrate")) * 8
                except ValueError:
                    pass
    return md


class KvpStore:
    """Read-only static device data (KvpStore.h: manufacturer/model info
    supplied at composition time, queried by providers)."""

    def __init__(self, values: Optional[dict[str, str]] = None):
        self._values = {
            "Manufacturer.Name": "OpenHome",
            "Manufacturer.Url": "http://www.openhome.org",
            "Model.Name": "ohpipeline-jax",
            "Model.Url": "",
            "Model.Info": "Device-batched OpenHome media renderer",
            **(values or {})}

    def get(self, key: str) -> str:
        return self._values[key]

    def has(self, key: str) -> bool:
        return key in self._values


class MuteManager:
    """Named mute registry with aggregate state (MuteManager.h)."""

    def __init__(self):
        self._mutes: dict[str, bool] = {}
        self._clients: dict[str, object] = {}
        self._observers: list[Callable[[bool], None]] = []
        self._lock = threading.Lock()

    def register(self, name: str, mute_client) -> None:
        """mute_client provides mute()/unmute()."""
        with self._lock:
            self._clients[name] = mute_client
            self._mutes.setdefault(name, False)

    def add_observer(self, cb: Callable[[bool], None]) -> None:
        self._observers.append(cb)

    @property
    def muted(self) -> bool:
        with self._lock:
            return any(self._mutes.values())

    def mute(self, name: str) -> None:
        self._set(name, True)

    def unmute(self, name: str) -> None:
        self._set(name, False)

    def _set(self, name: str, muted: bool) -> None:
        with self._lock:
            if name not in self._clients:
                raise KeyError(name)
            before = any(self._mutes.values())
            self._mutes[name] = muted
            after = any(self._mutes.values())
            client = self._clients[name]
        if muted:
            client.mute()
        else:
            client.unmute()
        if before != after:
            for cb in self._observers:
                cb(after)


class MimeTypeList:
    """Advertised mime types, fed by codec/protocol registration
    (MimeTypeList.h; surfaced through ProtocolInfo)."""

    def __init__(self):
        self._types: list[str] = []

    def add(self, mime: str) -> None:
        if mime not in self._types:
            self._types.append(mime)

    def add_codec(self, codec) -> None:
        for m in getattr(codec, "mime_types", ()):
            self.add(m)

    def populate_from_registry(self, registry) -> None:
        for codec in registry.instantiate():
            self.add_codec(codec)

    @property
    def types(self) -> list[str]:
        return list(self._types)

    def protocol_info(self) -> str:
        """UPnP-style ProtocolInfo CSV."""
        return ",".join(f"http-get:*:{m}:*" for m in self._types)


class FriendlyNameManager:
    """Composes '<room>:<name>' and notifies on changes
    (FriendlyNameManager.h; mDNS/UPnP naming feeds off this)."""

    def __init__(self, product):
        self._product = product
        self._observers: dict[int, Callable[[str], None]] = {}
        self._next = 1
        product.add_observer(self._changed)
        product.room_cfg.subscribe(lambda k, v: self._changed())
        product.name_cfg.subscribe(lambda k, v: self._changed())

    @property
    def friendly_name(self) -> str:
        return f"{self._product.room}:{self._product.name}"

    def register(self, cb: Callable[[str], None]) -> int:
        sid = self._next
        self._next += 1
        self._observers[sid] = cb
        cb(self.friendly_name)
        return sid

    def deregister(self, sid: int) -> None:
        self._observers.pop(sid, None)

    def _changed(self) -> None:
        name = self.friendly_name
        for cb in list(self._observers.values()):
            cb(name)


class TransportRepeatRandom:
    """Repeat/random transport state with observers
    (TransportControl.h TransportRepeatRandom)."""

    def __init__(self):
        self.repeat = False
        self.random = False
        self._observers: list[Callable[[bool, bool], None]] = []

    def add_observer(self, cb: Callable[[bool, bool], None]) -> None:
        self._observers.append(cb)
        cb(self.repeat, self.random)

    def set_repeat(self, on: bool) -> None:
        if self.repeat != on:
            self.repeat = on
            self._notify()

    def set_random(self, on: bool) -> None:
        if self.random != on:
            self.random = on
            self._notify()

    def _notify(self):
        for cb in self._observers:
            cb(self.repeat, self.random)

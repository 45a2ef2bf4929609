"""Songcast multiroom: the OHM/OHU wire protocol, sender and receiver.

Parity targets: Av/Songcast/Ohm.h (wire layout, port 51970, msg types
Join/Listen/Leave/Audio/Track/Metatext/Slave/Resend), OhmSender.cpp
(multicast/unicast fan-out, resend history), ProtocolOhm.cpp (receive,
gap detection + resend requests, latency via MsgDelay), ZoneHandler (OHZ).
Wire format is byte-compatible with the reference (layout from the
documented offsets in Ohm.h:57-140).

Device mapping (SURVEY.md §5.8): host UDP carries the frames; the
decoded batches ride the same device render path as local playback;
mesh collectives replace OHM only for device-to-device fan-out inside
one host (parallel.room_fanout).
"""

from __future__ import annotations

import socket
import struct
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Optional

import numpy as np

OHM_PORT = 51970
MCAST_ADDR = "239.253.1.1"   # zone-derived in the reference; fixed default

MSG_JOIN, MSG_LISTEN, MSG_LEAVE, MSG_AUDIO, MSG_TRACK, MSG_METATEXT, \
    MSG_SLAVE, MSG_RESEND = range(8)

FLAG_HALT = 1
FLAG_LOSSLESS = 2
FLAG_TIMESTAMPED = 4
FLAG_RESENT = 8

AUDIO_HEADER_BYTES = 50


def header(msg_type: int, payload_bytes: int) -> bytes:
    """OhmHeader (Ohm.h:57): 'Ohm ' + major + type + total bytes."""
    return struct.pack(">4sBBH", b"Ohm ", 1, msg_type, 8 + payload_bytes)


def parse_header(data: bytes) -> Optional[tuple[int, int]]:
    if len(data) < 8 or data[:4] != b"Ohm " or data[4] != 1:
        return None
    return data[5], struct.unpack(">H", data[6:8])[0] - 8


@dataclass(slots=True)
class OhmAudio:
    """OhmHeaderAudio (Ohm.h:120-140 layout)."""
    frame: int
    sample_start: int
    samples_total: int
    sample_rate: int
    bit_depth: int
    channels: int
    payload: bytes                 # big-endian interleaved packed PCM
    halt: bool = False
    lossless: bool = True
    timestamped: bool = False
    resent: bool = False
    network_timestamp: int = 0
    media_latency: int = 0
    media_timestamp: int = 0
    bit_rate: int = 0
    volume_offset: int = 0
    codec_name: bytes = b"PCM"

    @property
    def samples(self) -> int:
        frame_bytes = self.channels * (self.bit_depth // 8)
        return len(self.payload) // frame_bytes if frame_bytes else 0

    def encode(self) -> bytes:
        flags = ((FLAG_HALT if self.halt else 0)
                 | (FLAG_LOSSLESS if self.lossless else 0)
                 | (FLAG_TIMESTAMPED if self.timestamped else 0)
                 | (FLAG_RESENT if self.resent else 0))
        hdr = struct.pack(
            ">BBHIIIIQQIIhBBBB", AUDIO_HEADER_BYTES, flags, self.samples,
            self.frame, self.network_timestamp, self.media_latency,
            self.media_timestamp, self.sample_start, self.samples_total,
            self.sample_rate, self.bit_rate, self.volume_offset,
            self.bit_depth, self.channels, 0, len(self.codec_name))
        body = hdr + self.codec_name + self.payload
        return header(MSG_AUDIO, len(body)) + body

    @staticmethod
    def decode(payload: bytes) -> "OhmAudio":
        (hdr_bytes, flags, samples, frame, nts, latency, mts, sample_start,
         samples_total, rate, bit_rate, vol_off, depth, channels, _resv,
         name_len) = struct.unpack(">BBHIIIIQQIIhBBBB",
                                   payload[:AUDIO_HEADER_BYTES])
        name = payload[hdr_bytes:hdr_bytes + name_len]
        audio = payload[hdr_bytes + name_len:]
        return OhmAudio(
            frame=frame, sample_start=sample_start,
            samples_total=samples_total, sample_rate=rate, bit_depth=depth,
            channels=channels, payload=audio, halt=bool(flags & FLAG_HALT),
            lossless=bool(flags & FLAG_LOSSLESS),
            timestamped=bool(flags & FLAG_TIMESTAMPED),
            resent=bool(flags & FLAG_RESENT), network_timestamp=nts,
            media_latency=latency, media_timestamp=mts, bit_rate=bit_rate,
            volume_offset=vol_off, codec_name=name)


def encode_track(sequence: int, uri: bytes, metadata: bytes) -> bytes:
    body = struct.pack(">III", sequence, len(uri), len(metadata)) \
        + uri + metadata
    return header(MSG_TRACK, len(body)) + body


def decode_track(payload: bytes) -> tuple[int, bytes, bytes]:
    seq, ulen, mlen = struct.unpack(">III", payload[:12])
    return seq, payload[12:12 + ulen], payload[12 + ulen:12 + ulen + mlen]


def encode_metatext(sequence: int, metatext: bytes) -> bytes:
    body = struct.pack(">II", sequence, len(metatext)) + metatext
    return header(MSG_METATEXT, len(body)) + body


def decode_metatext(payload: bytes) -> tuple[int, bytes]:
    seq, mlen = struct.unpack(">II", payload[:8])
    return seq, payload[8:8 + mlen]


def encode_resend(frames: list[int]) -> bytes:
    body = struct.pack(">I", len(frames)) \
        + b"".join(struct.pack(">I", f) for f in frames)
    return header(MSG_RESEND, len(body)) + body


def decode_resend(payload: bytes) -> list[int]:
    n = struct.unpack(">I", payload[:4])[0]
    return list(struct.unpack(f">{n}I", payload[4:4 + 4 * n]))


def encode_simple(msg_type: int) -> bytes:
    return header(msg_type, 0)


def encode_slave(endpoints: list[tuple[str, int]]) -> bytes:
    body = struct.pack(">I", len(endpoints))
    for addr, port in endpoints:
        body += socket.inet_aton(addr) + struct.pack(">H", port)
    return header(MSG_SLAVE, len(body)) + body


class OhmSender:
    """Sends the pipeline's decoded audio as OHM frames (OhmSender.cpp).

    Attach as a Brancher/SenderThread tap: call `send_audio` with
    (channels, n) int32 native-range PCM.  Keeps a resend history ring and
    answers MSG_RESEND requests (kMsgTypeResend repair).
    """

    HISTORY = 100

    def __init__(self, uri: str = "", multicast: bool = True,
                 addr: str = MCAST_ADDR, port: int = OHM_PORT,
                 latency_ms: int = 150):
        self.addr = addr
        self.port = port
        self.multicast = multicast
        self.latency_ms = latency_ms
        self._frame = 0
        self._track_seq = 0
        self._meta_seq = 0
        self._history: dict[int, bytes] = {}
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        if multicast:
            self._sock.setsockopt(socket.IPPROTO_IP, socket.IP_MULTICAST_TTL,
                                  2)
        self._listeners: set[tuple[str, int]] = set()
        self._lock = threading.Lock()
        self._running = False
        self._rx_thread: Optional[threading.Thread] = None

    def start(self) -> None:
        """Listen for Join/Resend requests on our socket."""
        self._running = True
        self._sock.bind(("", 0))
        self._rx_thread = threading.Thread(target=self._rx_loop, daemon=True,
                                           name="OhmSenderRx")
        self._rx_thread.start()

    def stop(self) -> None:
        self._running = False
        try:
            self._sock.close()
        except OSError:
            pass

    @property
    def endpoint(self) -> tuple[str, int]:
        return self._sock.getsockname()

    def _rx_loop(self) -> None:
        while self._running:
            try:
                data, src = self._sock.recvfrom(8192)
            except OSError:
                break
            h = parse_header(data)
            if h is None:
                continue
            msg_type, _ = h
            if msg_type in (MSG_JOIN, MSG_LISTEN):
                with self._lock:
                    self._listeners.add(src)
            elif msg_type == MSG_LEAVE:
                with self._lock:
                    self._listeners.discard(src)
            elif msg_type == MSG_RESEND:
                for f in decode_resend(data[8:]):
                    pkt = self._history.get(f)
                    if pkt:
                        self._sock.sendto(pkt, src)

    def _tx(self, pkt: bytes) -> None:
        if self.multicast:
            self._sock.sendto(pkt, (self.addr, self.port))
        else:
            with self._lock:
                targets = list(self._listeners)
            for t in targets:
                self._sock.sendto(pkt, t)

    def send_track(self, uri: str, metadata: str = "") -> None:
        self._track_seq += 1
        self._tx(encode_track(self._track_seq, uri.encode(),
                              metadata.encode()))

    def send_metatext(self, text: str) -> None:
        self._meta_seq += 1
        self._tx(encode_metatext(self._meta_seq, text.encode()))

    def send_audio(self, samples: np.ndarray, sample_rate: int,
                   bit_depth: int, sample_start: int = 0,
                   samples_total: int = 0, halt: bool = False) -> int:
        """(channels, n) int32 native range -> one OHM audio frame."""
        from ..ops.pcm import pack_pcm_bytes
        payload = pack_pcm_bytes(samples, bit_depth, big_endian=True)
        self._frame += 1
        msg = OhmAudio(
            frame=self._frame, sample_start=sample_start,
            samples_total=samples_total, sample_rate=sample_rate,
            bit_depth=bit_depth, channels=samples.shape[0], payload=payload,
            halt=halt,
            media_latency=self.latency_ms * 44100 * 256 // 1000)
        pkt = msg.encode()
        self._history[self._frame] = pkt
        if len(self._history) > self.HISTORY:
            del self._history[min(self._history)]
        self._tx(pkt)
        return self._frame


OHZ_PORT = 51972
OHZ_MCAST = "239.255.255.250"
OHZ_QUERY, OHZ_ZONE_URI, OHZ_PRESET_QUERY, OHZ_PRESET_INFO = range(4)


def ohz_header(msg_type: int, payload_bytes: int) -> bytes:
    """OHZ framing (ZoneHandler.h: 'Ohz ' + version + type + bytes)."""
    return struct.pack(">4sBBH", b"Ohz ", 1, msg_type, 8 + payload_bytes)


def encode_zone_query(zone: str) -> bytes:
    z = zone.encode()
    body = struct.pack(">I", len(z)) + z
    return ohz_header(OHZ_QUERY, len(body)) + body


def encode_zone_uri(zone: str, uri: str) -> bytes:
    z, u = zone.encode(), uri.encode()
    body = struct.pack(">II", len(z), len(u)) + z + u
    return ohz_header(OHZ_ZONE_URI, len(body)) + body


def parse_ohz(data: bytes):
    """Returns (type, dict) or None."""
    if len(data) < 8 or data[:4] != b"Ohz " or data[4] != 1:
        return None
    t = data[5]
    p = data[8:]
    if t == OHZ_QUERY:
        n = struct.unpack(">I", p[:4])[0]
        return t, {"zone": p[4:4 + n].decode()}
    if t == OHZ_ZONE_URI:
        zn, un = struct.unpack(">II", p[:8])
        return t, {"zone": p[8:8 + zn].decode(),
                   "uri": p[8 + zn:8 + zn + un].decode()}
    return t, {}


class ZoneHandler:
    """OHZ zone discovery (ZoneHandler.h:25): a sender answers zone
    queries with its OHM endpoint URI; receivers query a zone name to
    find the sender to join."""

    def __init__(self, zone: str, ohm_uri: str = "", multicast: bool = True,
                 port: int = OHZ_PORT):
        self.zone = zone
        self.ohm_uri = ohm_uri
        self.port = port
        self.multicast = multicast
        self._sock: Optional[socket.socket] = None
        self._running = False
        self.discovered: dict[str, str] = {}
        #: ZoneUriChanged listener (IZoneListener, ZoneHandler.h):
        #: called (zone, uri) whenever a zone-uri answer arrives
        self.on_zone_uri: Optional[Callable[[str, str], None]] = None
        #: zone preset number, answered to OHZ preset queries
        self.preset = 0

    def start(self) -> None:
        s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        s.bind(("", self.port if self.multicast else 0))
        if self.multicast:
            mreq = socket.inet_aton(OHZ_MCAST) + socket.inet_aton("0.0.0.0")
            s.setsockopt(socket.IPPROTO_IP, socket.IP_ADD_MEMBERSHIP, mreq)
        s.settimeout(0.2)
        self._sock = s
        self._running = True
        threading.Thread(target=self._loop, daemon=True,
                         name="ZoneHandler").start()

    def stop(self) -> None:
        self._running = False
        if self._sock:
            self._sock.close()

    @property
    def endpoint(self) -> tuple[str, int]:
        return self._sock.getsockname()

    def query(self, zone: str,
              target: Optional[tuple[str, int]] = None) -> None:
        dest = target or (OHZ_MCAST, self.port)
        self._sock.sendto(encode_zone_query(zone), dest)

    def _loop(self) -> None:
        while self._running:
            try:
                data, src = self._sock.recvfrom(8192)
            except socket.timeout:
                continue
            except OSError:
                break
            parsed = parse_ohz(data)
            if parsed is None:
                continue
            t, fields = parsed
            if t == OHZ_QUERY and fields.get("zone") == self.zone \
                    and self.ohm_uri:
                self._sock.sendto(encode_zone_uri(self.zone, self.ohm_uri),
                                  src)
            elif t == OHZ_ZONE_URI:
                self.discovered[fields["zone"]] = fields["uri"]
                if self.on_zone_uri is not None:
                    self.on_zone_uri(fields["zone"], fields["uri"])


@dataclass(slots=True)
class ReceiverStats:
    frames: int = 0
    gaps: int = 0
    resends_requested: int = 0
    resends_recovered: int = 0


class OhmReceiver:
    """Receives an OHM stream (ProtocolOhm.cpp): join, reorder, request
    resends on gaps, deliver PCM in frame order.

    `on_audio(samples int32 (ch, n), OhmAudio)` is called in order;
    `on_track`/`on_metatext` surface metadata.
    """

    def __init__(self, on_audio: Callable[[np.ndarray, OhmAudio], None],
                 on_track=None, on_metatext=None,
                 multicast: bool = True, addr: str = MCAST_ADDR,
                 port: int = OHM_PORT,
                 sender_endpoint: Optional[tuple[str, int]] = None):
        self.on_audio = on_audio
        self.on_track = on_track or (lambda uri, md: None)
        self.on_metatext = on_metatext or (lambda text: None)
        self.multicast = multicast
        self.addr = addr
        self.port = port
        self.sender_endpoint = sender_endpoint
        self.stats = ReceiverStats()
        self._expected: Optional[int] = None
        self._pending: dict[int, OhmAudio] = {}
        self._running = False
        self._sock: Optional[socket.socket] = None
        self._thread: Optional[threading.Thread] = None

    def start(self) -> None:
        s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        if self.multicast:
            s.bind(("", self.port))
            mreq = socket.inet_aton(self.addr) + socket.inet_aton("0.0.0.0")
            s.setsockopt(socket.IPPROTO_IP, socket.IP_ADD_MEMBERSHIP, mreq)
        else:
            s.bind(("", 0))
        s.settimeout(0.2)
        self._sock = s
        self._running = True
        if self.sender_endpoint:
            s.sendto(encode_simple(MSG_JOIN), self.sender_endpoint)
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="OhmReceiver")
        self._thread.start()

    def stop(self) -> None:
        self._running = False
        if self._sock and self.sender_endpoint:
            try:
                self._sock.sendto(encode_simple(MSG_LEAVE),
                                  self.sender_endpoint)
            except OSError:
                pass
        if self._thread:
            self._thread.join(1.0)
        if self._sock:
            self._sock.close()

    def _loop(self) -> None:
        while self._running:
            try:
                data, _src = self._sock.recvfrom(65536)
            except socket.timeout:
                continue
            except OSError:
                break
            h = parse_header(data)
            if h is None:
                continue
            msg_type, _ = h
            payload = data[8:]
            if msg_type == MSG_AUDIO:
                self._handle_audio(OhmAudio.decode(payload))
            elif msg_type == MSG_TRACK:
                _seq, uri, md = decode_track(payload)
                self.on_track(uri.decode("utf-8", "replace"),
                              md.decode("utf-8", "replace"))
            elif msg_type == MSG_METATEXT:
                _seq, text = decode_metatext(payload)
                self.on_metatext(text.decode("utf-8", "replace"))

    def _handle_audio(self, msg: OhmAudio) -> None:
        self.stats.frames += 1
        if self._expected is None:
            self._expected = msg.frame
        if msg.frame < self._expected:
            return                      # duplicate/late
        if msg.frame > self._expected:
            self._pending[msg.frame] = msg
            gap = list(range(self._expected,
                             min(msg.frame, self._expected + 16)))
            missing = [f for f in gap if f not in self._pending]
            if missing and self.sender_endpoint:
                self.stats.gaps += 1
                self.stats.resends_requested += len(missing)
                try:
                    self._sock.sendto(encode_resend(missing),
                                      self.sender_endpoint)
                except OSError:
                    pass
            if len(self._pending) > 64:
                # give up on the gap (reference skips after timeout)
                self._expected = min(self._pending)
            else:
                return
        self._deliver(msg if msg.frame == self._expected
                      else self._pending.pop(self._expected, None))

    def _deliver(self, msg: Optional[OhmAudio]) -> None:
        while msg is not None:
            if msg.resent:
                self.stats.resends_recovered += 1
            from ..ops.pcm import unpack_pcm_bytes
            samples = unpack_pcm_bytes(msg.payload, msg.bit_depth,
                                       msg.channels, big_endian=True)
            self.on_audio(samples, msg)
            self._expected = msg.frame + 1
            msg = self._pending.pop(self._expected, None)

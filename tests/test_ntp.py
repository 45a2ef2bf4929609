"""SNTP client + UnixTimestamp vs a scripted loopback NTP server
(reference test strategy: network components run against loopback
fakes, SURVEY.md §4.6; parity: OpenHome/NtpClient.cpp,
OpenHome/UnixTimestamp.cpp)."""

import socket
import struct
import threading
import time

import pytest

from ohpipeline_jax.net.ntp import (NTP_UNIX_EPOCH_DELTA, NtpClient,
                                    UnixTimestamp)


class FakeNtpServer:
    def __init__(self, unix_time: float, respond: bool = True):
        self.sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        self.sock.bind(("127.0.0.1", 0))
        self.port = self.sock.getsockname()[1]
        self.unix_time = unix_time
        self.respond = respond
        self.requests = 0
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        self.sock.settimeout(5.0)
        while True:
            try:
                data, addr = self.sock.recvfrom(64)
            except OSError:
                return
            self.requests += 1
            if not self.respond:
                continue
            if (data[0] & 7) != 3:       # client mode expected
                continue
            reply = bytearray(48)
            reply[0] = (0 << 6) | (4 << 3) | 4       # server mode
            secs = int(self.unix_time) + NTP_UNIX_EPOCH_DELTA
            frac = int((self.unix_time % 1.0) * 2 ** 32)
            reply[40:48] = struct.pack(">II", secs, frac)
            self.sock.sendto(bytes(reply), addr)

    def close(self):
        self.sock.close()


def test_ntp_query_roundtrip():
    srv = FakeNtpServer(1_766_000_000.25)
    try:
        c = NtpClient(servers=["127.0.0.1"], port=srv.port, timeout_s=2.0)
        got = c.try_get_network_time()
        assert got is not None
        ts, delay_ms = got
        assert abs(ts.as_unix() - 1_766_000_000.25) < 1e-3
        assert 0.0 <= delay_ms < 2000.0
    finally:
        srv.close()


def test_ntp_server_rotation_on_failure():
    dead = FakeNtpServer(0, respond=False)
    live = FakeNtpServer(1_766_000_123.0)
    try:
        # both on loopback with different ports: simulate rotation by a
        # client whose port only matches the live server second
        c = NtpClient(servers=["127.0.0.1", "127.0.0.1"], port=live.port,
                      timeout_s=1.0)
        got = c.try_get_network_time()
        assert got is not None
    finally:
        dead.close()
        live.close()


def test_unix_timestamp_now_and_monotonic_mapping():
    srv = FakeNtpServer(1_766_000_500.0)
    try:
        c = NtpClient(servers=["127.0.0.1"], port=srv.port, timeout_s=2.0)
        ut = UnixTimestamp(client=c)
        now = ut.now()
        assert abs(now - 1_766_000_500.0) < 1.5
        # mapping an absolute start 0.5s ahead lands ~0.5s ahead on the
        # monotonic clock (StarterTimed.start_at consumes this)
        target = ut.unix_to_monotonic(now + 0.5)
        assert 0.3 < target - time.monotonic() < 0.8
        # cached between resyncs: a second call doesn't hit the server
        reqs = srv.requests
        ut.now()
        assert srv.requests == reqs
        ut.reset()
        ut.now()
        assert srv.requests == reqs + 1
    finally:
        srv.close()


def test_unix_timestamp_unavailable():
    dead = FakeNtpServer(0, respond=False)
    try:
        c = NtpClient(servers=["127.0.0.1"], port=dead.port, timeout_s=0.3)
        ut = UnixTimestamp(client=c)
        with pytest.raises(RuntimeError):
            ut.now()
    finally:
        dead.close()

"""mDNS responder tests: query/answer over loopback unicast (the
responder answers the querier directly, so no multicast group needed)."""

import socket
import struct
import time

from ohpipeline_jax.net import mdns as M


def query(name: str, qtype: int) -> bytes:
    return (struct.pack(">HHHHHH", 0x1234, 0, 1, 0, 0, 0)
            + M.encode_name(name) + struct.pack(">HH", qtype, 1))


def parse_answers(data: bytes) -> list[tuple[str, int, bytes]]:
    tid, flags, qd, an, _, _ = struct.unpack(">HHHHHH", data[:12])
    assert flags & 0x8000
    pos = 12
    out = []
    for _ in range(an):
        name, pos = M.decode_name(data, pos)
        rtype, _cls, _ttl, rdlen = struct.unpack(">HHIH",
                                                 data[pos:pos + 10])
        pos += 10
        out.append((name, rtype, data[pos:pos + rdlen]))
        pos += rdlen
    return out


class TestMdns:
    def test_name_roundtrip(self):
        raw = M.encode_name("_raop._tcp.local")
        name, end = M.decode_name(raw, 0)
        assert name == "_raop._tcp.local" and end == len(raw)

    def test_ptr_srv_txt_answers(self):
        rx = M.MdnsResponder(multicast=False)
        try:
            M.announce_media_player(rx, "Den", raop_port=5000,
                                    odp_port=7777, web_port=8080,
                                    mac="AABBCCDDEEFF")
            cli = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
            cli.settimeout(5.0)
            cli.sendto(query("_raop._tcp.local", M.TYPE_PTR),
                       ("127.0.0.1", rx.port))
            data, _ = cli.recvfrom(4096)
            ans = parse_answers(data)
            types = {a[1] for a in ans}
            assert {M.TYPE_PTR, M.TYPE_SRV, M.TYPE_TXT, M.TYPE_A} <= types
            ptr = next(a for a in ans if a[1] == M.TYPE_PTR)
            target, _ = M.decode_name(ptr[2], 0)
            assert target == "AABBCCDDEEFF@Den._raop._tcp.local"
            srv = next(a for a in ans if a[1] == M.TYPE_SRV)
            _pri, _wt, port = struct.unpack(">HHH", srv[2][:6])
            assert port == 5000
            txt = next(a for a in ans if a[1] == M.TYPE_TXT)
            assert b"am=ohpipeline-jax" in txt[2]
            # instance-name SRV query
            cli.sendto(query("AABBCCDDEEFF@Den._raop._tcp.local",
                             M.TYPE_SRV), ("127.0.0.1", rx.port))
            data, _ = cli.recvfrom(4096)
            assert parse_answers(data)
            # unknown name: silence
            cli.sendto(query("_nope._tcp.local", M.TYPE_PTR),
                       ("127.0.0.1", rx.port))
            cli.settimeout(0.3)
            try:
                cli.recvfrom(4096)
                got_reply = True
            except socket.timeout:
                got_reply = False
            assert not got_reply
            cli.close()
        finally:
            rx.close()

    def test_ignores_responses(self):
        rx = M.MdnsResponder(multicast=False)
        try:
            assert rx._respond(struct.pack(">HHHHHH", 0, 0x8400,
                                           0, 0, 0, 0)) is None
            assert rx._respond(b"\x00") is None
        finally:
            rx.close()

    def test_goodbye_on_close(self):
        rx = M.MdnsResponder(multicast=False)
        svc = M.MdnsService("_odp._tcp.local", "X", 1234)
        rx.register(svc)
        recs = svc.records(ttl=0)
        # ttl field of the first record is zero
        name_len = len(M.encode_name("_odp._tcp.local"))
        _t, _c, ttl, _l = struct.unpack(">HHIH",
                                        recs[name_len:name_len + 10])
        assert ttl == 0
        rx.close()
        time.sleep(0.25)

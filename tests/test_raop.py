"""RAOP receiver tests: full RTSP handshake + encrypted RTP ALAC audio
over loopback with resend repair (reference TestRaop style)."""

import pathlib
import socket
import struct
import subprocess
import time

import numpy as np
import pytest

from ohpipeline_jax.net import raop as R

ALAC_ORACLE = pathlib.Path(__file__).resolve().parent.parent / \
    ".oracle_build" / "alac_oracle"


def rtsp(sock_file, method, url="rtsp://x", headers=None, body=b""):
    h = {"CSeq": "1", **(headers or {})}
    if body:
        h["Content-Length"] = str(len(body))
    req = f"{method} {url} RTSP/1.0\r\n" + \
        "".join(f"{k}: {v}\r\n" for k, v in h.items()) + "\r\n"
    sock_file.write(req.encode() + body)
    sock_file.flush()
    status = sock_file.readline().decode()
    resp = {}
    while True:
        line = sock_file.readline().decode().strip()
        if not line:
            break
        k, _, v = line.partition(":")
        resp[k.strip().lower()] = v.strip()
    return status, resp


class TestSdp:
    def test_parse_and_alac_config(self):
        sdp = ("v=0\r\no=iTunes 1 0 IN IP4 10.0.0.2\r\n"
               "m=audio 0 RTP/AVP 96\r\n"
               "a=rtpmap:96 AppleLossless\r\n"
               "a=fmtp:96 352 0 16 40 10 14 2 255 0 0 44100\r\n"
               "a=aesiv:AAECAwQFBgcICQoLDA0ODw\r\n")
        p = R.parse_sdp(sdp)
        cfg = R.alac_config_from_fmtp(p["fmtp"])
        assert cfg.frame_length == 352 and cfg.sample_rate == 44100
        assert cfg.bit_depth == 16 and cfg.num_channels == 2
        assert len(R._b64pad(p["aesiv"])) == 16


@pytest.mark.skipif(not ALAC_ORACLE.exists(), reason="alac oracle not built")
class TestRaopSession:
    def _alac_packets(self, tmp_path, n=6):
        t = np.arange(4096 * n) / 44100
        x = np.stack([np.rint(np.sin(2 * np.pi * 997 * t) * 15000),
                      np.rint(np.sin(2 * np.pi * 1009 * t) * 15000)]) \
            .astype(np.int16)
        fin, fout = tmp_path / "in.raw", tmp_path / "o.alac"
        np.ascontiguousarray(x.T).tofile(fin)
        # RAOP uses 352-sample frames: re-encode with the oracle's default
        # 4096 then just use our own packets? -> craft with frameLength 352
        # via the oracle is fixed at 4096; instead decode-side config 4096.
        subprocess.run([str(ALAC_ORACLE), "encode", str(fin), str(fout),
                        "44100", "2"], check=True)
        raw = fout.read_bytes()
        clen = struct.unpack("<I", raw[:4])[0]
        cookie = raw[4:4 + clen]
        p = 4 + clen
        npk = struct.unpack("<I", raw[p:p + 4])[0]
        p += 4
        pkts = []
        for _ in range(npk):
            sz = struct.unpack("<I", raw[p:p + 4])[0]
            p += 4
            pkts.append(raw[p:p + sz])
            p += sz
        return x, cookie, pkts

    def test_full_session_with_encryption_and_loss(self, tmp_path):
        from cryptography.hazmat.primitives.ciphers import (Cipher,
                                                            algorithms,
                                                            modes)
        from ohpipeline_jax.codecs.alac import AlacConfig
        x, cookie, pkts = self._alac_packets(tmp_path)
        cfg = AlacConfig.parse(cookie)
        got = []
        events = []
        rx = R.RaopReceiver(lambda s: got.append(s),
                            on_session=lambda sess, ev: events.append(ev))
        # RTSP handshake
        conn = socket.create_connection(("127.0.0.1", rx.rtsp_port),
                                        timeout=5)
        f = conn.makefile("rwb")
        key = bytes(range(16))
        iv = bytes(range(16, 32))
        sdp = (f"a=fmtp:96 {cfg.frame_length} 0 {cfg.bit_depth} {cfg.pb} "
               f"{cfg.mb} {cfg.kb} {cfg.num_channels} {cfg.max_run} 0 0 "
               f"{cfg.sample_rate}\r\n").encode()
        status, _ = rtsp(f, "ANNOUNCE", body=sdp)
        assert "200" in status
        rx.set_aes(key, iv)            # in lieu of the Apple-RSA exchange
        status, resp = rtsp(f, "SETUP")
        assert "200" in status
        transport = resp["transport"]
        ports = dict(kv.split("=") for kv in transport.split(";")
                     if "=" in kv)
        audio_port = int(ports["server_port"])
        status, resp = rtsp(f, "RECORD")
        assert "200" in status and "audio-latency" in resp
        rtsp(f, "SET_PARAMETER", body=b"volume: -12.5\r\n")
        assert rx.session.volume_db == -12.5

        # RTP: send packets, drop one, answer the resend request
        tx = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        tx.bind(("127.0.0.1", 0))
        tx.settimeout(15.0)

        def encrypt(p):
            enc_len = len(p) & ~0xF
            enc = Cipher(algorithms.AES(key), modes.CBC(iv)).encryptor()
            return enc.update(p[:enc_len]) + p[enc_len:]

        def rtp(seq, payload, ptype=96):
            hdr = struct.pack(">BBHII", 0x80, ptype, seq, seq * 352, 1)
            return hdr + encrypt(payload)

        dropped = 2
        for i, pk in enumerate(pkts):
            if i == dropped:
                continue
            tx.sendto(rtp(100 + i, pk), ("127.0.0.1", audio_port))
        # receiver must ask for the missing sequence on the control port
        data, src = tx.recvfrom(1024)
        ptype = data[1] & 0x7F
        first, count = struct.unpack(">HH", data[4:8])
        assert ptype == 0x55 and first == 100 + dropped
        # answer with the retransmit format: 4-byte resend header followed
        # by the original RTP packet (payload lands at offset 16, but the
        # SEQ the receiver reads sits at offset 2 — set it to the dropped
        # sequence in the resend header too)
        original = rtp(100 + dropped, pkts[dropped])
        pkt = struct.pack(">BBH", 0x80, 86 | 0x80, 100 + dropped) + \
            original[:12][4:8] + original
        # receiver reads seq at bytes 2..4 and payload at 16: our resend
        # header is 4 bytes [ver, 86, seq], then the 12-byte RTP header
        pkt = struct.pack(">BBH", 0x80, 86, 100 + dropped) + original
        tx.sendto(pkt, ("127.0.0.1", audio_port))

        deadline = time.time() + 20
        while len(got) < len(pkts) and time.time() < deadline:
            time.sleep(0.05)
        rtsp(f, "TEARDOWN")
        conn.close()
        rx.close()
        assert len(got) == len(pkts), len(got)
        pcm = np.concatenate(got, axis=1)
        np.testing.assert_array_equal(
            pcm[:, :x.shape[1]].astype(np.int16), x)
        assert {"announce", "setup", "record", "volume",
                "teardown"} <= set(events)

"""UDP pose streaming — counterpart of the reference's SlimeVR client
(reference examples/slime.cpp:1-324: discovery handshake, heartbeat, rotation
packets to a SlimeVR full-body-tracking server).

Implements the SlimeVR owoTrack-style packet framing the reference uses:
big-endian (packet_type: u32, packet_id: u64, payload). Handshake (type 3),
heartbeat (type 0), rotation quaternion (type 1, x y z w f32). A generic JSON
pose publisher is also provided for non-SlimeVR consumers.

Port of the JAX package's utils/pose_stream.py (NumPy and sockets only).
"""

from __future__ import annotations

import json
import socket
import struct
import time
from typing import Optional

import numpy as np

HANDSHAKE = 3
HEARTBEAT = 0
ROTATION = 1


class SlimeVrClient:
    def __init__(self, host: str = "127.0.0.1", port: int = 6969):
        self.addr = (host, port)
        self.sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        self.sock.setblocking(False)
        self.packet_id = 0
        self._last_heartbeat = 0.0
        self.connected = False

    def discover_server(self, device_id: int = 0, timeout: float = 5.0,
                        broadcast_host: str = "255.255.255.255") -> bool:
        """Broadcast-discover the SlimeVR server (reference
        slime.cpp:196-275 slimeDiscoverServer): bind a stable local port
        (9185 + device_id, so the server can re-associate the tracker after
        restarts), broadcast a handshake to <broadcast>:6969, and wait up to
        `timeout` s for the server's `PACKET_HANDSHAKE` + "Hey OVR =D 5"
        response; on success all subsequent packets go directly to the
        responding address."""
        if self.connected:
            return True
        try:
            self.sock.bind(("", 9185 + device_id))
        except OSError:
            pass  # best-effort, like the reference (a failed bind only
            # risks reconnect trouble)
        self.sock.setsockopt(socket.SOL_SOCKET, socket.SO_BROADCAST, 1)
        self.sock.settimeout(timeout)
        try:
            # handshake payload matching slime.cpp:227-241 (packet number 0,
            # zeroed board/imu/mcu fields, build 1, short firmware string,
            # 6-byte pseudo-mac derived from device_id)
            mac = bytes([255, device_id & 0xFF, device_id % 2, 120, 125, 0])
            fw = b"UWUFirmware"
            payload = (
                struct.pack(">IQ", HANDSHAKE, 0)
                + struct.pack(">IIIIIII", 0, 0, 0, 0, 0, 0, 1)
                + bytes([len(fw)]) + fw + mac
            )
            self.sock.sendto(payload, (broadcast_host, self.addr[1]))
            deadline = time.monotonic() + timeout
            while time.monotonic() < deadline:
                try:
                    data, addr = self.sock.recvfrom(1024)
                except (socket.timeout, OSError):
                    return False
                if len(data) >= 13 and data[0] == HANDSHAKE \
                        and data[1:13] == b"Hey OVR =D 5":
                    self.addr = addr
                    self.connected = True
                    return True
            return False
        finally:
            self.sock.setsockopt(socket.SOL_SOCKET, socket.SO_BROADCAST, 0)
            self.sock.setblocking(False)

    def _send(self, ptype: int, payload: bytes = b""):
        msg = struct.pack(">IQ", ptype, self.packet_id) + payload
        self.packet_id += 1
        try:
            self.sock.sendto(msg, self.addr)
        except OSError:
            pass  # non-blocking best-effort, like the reference's UDP client

    def handshake(self, board_type: int = 13, imu_type: int = 0,
                  mcu_type: int = 3, firmware: str = "rd_vio_tpu_torch"):
        fw = firmware.encode()[:15]
        payload = struct.pack(
            ">III", board_type, imu_type, mcu_type
        ) + struct.pack(">III", 0, 0, 0) + struct.pack(">I", 0)
        payload += bytes([len(fw)]) + fw
        payload += bytes(6)  # mac
        self._send(HANDSHAKE, payload)

    def heartbeat(self, interval: float = 0.8):
        now = time.monotonic()
        if now - self._last_heartbeat >= interval:
            self._send(HEARTBEAT)
            self._last_heartbeat = now

    def send_rotation(self, q_wxyz):
        """Rotation packet: SlimeVR expects x y z w order."""
        q = np.asarray(q_wxyz, dtype=np.float32)
        payload = struct.pack(">ffff", q[1], q[2], q[3], q[0])
        self._send(ROTATION, payload)
        self.heartbeat()

    def close(self):
        self.sock.close()


class JsonPosePublisher:
    """Plain JSON-over-UDP pose stream for generic consumers."""

    def __init__(self, host: str = "127.0.0.1", port: int = 9870):
        self.addr = (host, port)
        self.sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        self.sock.setblocking(False)

    def publish(self, t: float, q_wxyz, p):
        msg = json.dumps({
            "t": float(t),
            "q": [float(x) for x in q_wxyz],
            "p": [float(x) for x in p],
        }).encode()
        try:
            self.sock.sendto(msg, self.addr)
        except OSError:
            pass

    def close(self):
        self.sock.close()

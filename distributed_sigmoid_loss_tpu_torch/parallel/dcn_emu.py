"""An emulated dcn link: a throttled two-process localhost pipe, ported from
the JAX package's ``parallel/dcn_emu.py`` (standard library only, as JAX's).

On one host the dcn axis is virtual: its all-gather is a copy, so a timed
round measures compute and the controller's reactions, not wire savings.
With an emulator, after each step the host ships the step's
``dcn_wire_bytes`` across a localhost socket to a sink *process* that
drains it through a token bucket of ``--emu-dcn-mbps``. The measured
send-to-ack time goes into the step's wall clock and into
``BitController.observe``, so the bandwidth EWMA follows a measured
transfer.

One emulator per process, one sink subprocess (this file run as a script:
it imports nothing of the package), one long-lived TCP connection to
127.0.0.1. Each transfer is ``[int64 length][payload]`` down and ``[int64
bytes drained]`` back; the sink counts every byte, so a short read raises
:class:`RuntimeError` on the sending side, never a silently faster round. A
length of -1 is the shutdown handshake. The receiver throttles: after each
chunk it sleeps until ``bytes_so_far * 8 / mbps`` of wall clock has passed,
so a payload much larger than a chunk takes the serialization delay of an
``mbps`` link and a tiny one mostly the round trip.
"""

from __future__ import annotations

import argparse
import os
import socket
import struct
import subprocess
import sys
import time

__all__ = ["DCNEmulator", "serve"]

_HDR = struct.Struct("<q")
_CHUNK = 64 * 1024
_SHUTDOWN = -1


def _recv_exact(conn: socket.socket, n: int) -> bytes:
    parts = []
    while n:
        buf = conn.recv(n)
        if not buf:
            raise ConnectionError("peer closed mid-message")
        parts.append(buf)
        n -= len(buf)
    return b"".join(parts)


def _throttled_drain(conn: socket.socket, nbytes: int, mbps: float) -> int:
    """Read up to ``nbytes`` from ``conn``, pacing reads so the drain rate is
    ``mbps``. Returns the byte count actually read (== nbytes unless the
    peer died — the ack makes any shortfall loud on the other side)."""
    start = time.monotonic()
    got = 0
    while got < nbytes:
        buf = conn.recv(min(_CHUNK, nbytes - got))
        if not buf:
            break
        got += len(buf)
        lag = got * 8.0 / (mbps * 1e6) - (time.monotonic() - start)
        if lag > 0:
            time.sleep(lag)
    return got


def serve(port: int, mbps: float, *, announce=None) -> None:
    """Sink half (runs in the subprocess): accept ONE connection, drain
    length-prefixed payloads through the token bucket, ack each with the
    drained byte count, exit on the shutdown header."""
    if mbps <= 0:
        raise ValueError(f"emulated bandwidth must be > 0 Mbps, got {mbps}")
    srv = socket.create_server(("127.0.0.1", port))
    print(f"DCN_EMU_PORT {srv.getsockname()[1]}", flush=True,
          file=announce or sys.stdout)
    conn, _ = srv.accept()
    srv.close()
    try:
        while True:
            (length,) = _HDR.unpack(_recv_exact(conn, _HDR.size))
            if length == _SHUTDOWN:
                return
            got = _throttled_drain(conn, length, mbps)
            conn.sendall(_HDR.pack(got))
    except ConnectionError:
        return
    finally:
        conn.close()


class DCNEmulator:
    """Parent half: spawn the sink, own the connection, time transfers.

    >>> with DCNEmulator(mbps=200.0) as emu:
    ...     dt = emu.transfer(wire_bytes)     # measured seconds
    ...     controller.observe(dt, wire_bytes)

    ``measured_mbps`` is the EWMA of ``bytes * 8 / dt`` over completed
    transfers — the figure the ``dcn_measured_mbps`` metric stamps; for
    payloads well above one 64 KiB chunk it lands within ~2x of the
    configured throttle. No locks, no threads: one
    blocking socket used from the training loop's thread only.
    """

    def __init__(self, mbps: float, *, alpha: float = 0.5,
                 connect_timeout_s: float = 30.0):
        if mbps <= 0:
            raise ValueError(
                f"emulated bandwidth must be > 0 Mbps, got {mbps}"
            )
        self.mbps = float(mbps)
        self.alpha = float(alpha)
        self.connect_timeout_s = float(connect_timeout_s)
        self.transfers = 0
        self.bytes_total = 0
        self.measured_mbps: float | None = None
        self._proc: subprocess.Popen | None = None
        self._sock: socket.socket | None = None
        # One reusable zeros block; transfers loop over it so a multi-MB
        # payload never allocates its own buffer.
        self._block = memoryview(bytes(_CHUNK * 16))

    def start(self) -> "DCNEmulator":
        if self._sock is not None:
            return self
        env = dict(os.environ)
        self._proc = subprocess.Popen(
            [sys.executable, os.path.abspath(__file__),
             "--serve", "--mbps", str(self.mbps), "--port", "0"],
            stdout=subprocess.PIPE, text=True, env=env,
        )
        line = self._proc.stdout.readline()
        if not line.startswith("DCN_EMU_PORT "):
            raise RuntimeError(f"dcn_emu sink failed to start: {line!r}")
        port = int(line.split()[1])
        self._sock = socket.create_connection(
            ("127.0.0.1", port), timeout=self.connect_timeout_s
        )
        self._sock.settimeout(None)
        return self

    def transfer(self, nbytes) -> float:
        """Ship ``nbytes`` through the throttled pipe; return measured
        seconds (send start → ack). Raises if the sink drained a different
        byte count — a dropped byte must never read as a faster link."""
        nbytes = int(nbytes)
        if nbytes <= 0:
            return 0.0
        if self._sock is None:
            self.start()
        sock = self._sock
        t0 = time.monotonic()
        sock.sendall(_HDR.pack(nbytes))
        left = nbytes
        while left:
            take = min(left, len(self._block))
            sock.sendall(self._block[:take])
            left -= take
        (drained,) = _HDR.unpack(_recv_exact(sock, _HDR.size))
        dt = time.monotonic() - t0
        if drained != nbytes:
            raise RuntimeError(
                f"dcn_emu dropped bytes: sent {nbytes}, sink drained "
                f"{drained} — emulated measurements would be silently wrong"
            )
        self.transfers += 1
        self.bytes_total += nbytes
        if dt > 0:
            inst = nbytes * 8.0 / dt / 1e6
            self.measured_mbps = (
                inst if self.measured_mbps is None
                else self.alpha * inst + (1 - self.alpha) * self.measured_mbps
            )
        return dt

    def close(self) -> None:
        if self._sock is not None:
            try:
                self._sock.sendall(_HDR.pack(_SHUTDOWN))
            except OSError:
                pass
            self._sock.close()
            self._sock = None
        if self._proc is not None:
            try:
                self._proc.wait(timeout=10)
            except subprocess.TimeoutExpired:
                self._proc.kill()
                self._proc.wait()
            if self._proc.stdout is not None:
                self._proc.stdout.close()
            self._proc = None

    def __enter__(self) -> "DCNEmulator":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.close()


def _main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--serve", action="store_true", required=True)
    ap.add_argument("--mbps", type=float, required=True)
    ap.add_argument("--port", type=int, default=0)
    args = ap.parse_args(argv)
    serve(args.port, args.mbps)
    return 0


if __name__ == "__main__":
    sys.exit(_main())

"""The port's emulated dcn link (``parallel/dcn_emu.py``): JAX's five
oracles (``tests/test_dcn_emu.py``) at smaller payloads and rates.

- The throttle is honest both ways: a multi-chunk payload's measured rate
  lands within 2× of the set one, and a 10× slower throttle slows the same
  payload.
- No silent drop: a sink that acks another byte count raises.
- Accounting (``transfers``, ``bytes_total``, the ``measured_mbps`` EWMA);
  zero-byte transfers are free; shutdown is clean and closing twice is
  safe; a rate that is not positive is refused.

Standard library and the port only; the sink is the port's own file run as
a subprocess.
"""

import socket
import struct
import threading

import pytest

from distributed_sigmoid_loss_tpu_torch.parallel.dcn_emu import DCNEmulator

_HDR = struct.Struct("<q")


def test_throttle_honest_within_2x_and_reacts_to_rate():
    payload = 1024 * 1024  # 16 drain chunks: serialization delay dominates
    with DCNEmulator(200.0) as emu:
        emu.transfer(payload)  # settle the connection
        for _ in range(2):
            assert emu.transfer(payload) > 0.0
        fast = emu.measured_mbps
    assert 100.0 <= fast <= 400.0, fast
    with DCNEmulator(20.0) as emu:
        emu.transfer(64 * 1024)
        slow_dt = emu.transfer(payload // 2)
    ideal = (payload // 2) * 8.0 / (20.0 * 1e6)  # ~0.21 s at 20 Mbps
    assert slow_dt >= 0.5 * ideal, (slow_dt, ideal)
    assert 10.0 <= emu.measured_mbps <= 40.0, emu.measured_mbps


def test_transfer_accounting_and_zero_bytes_free():
    with DCNEmulator(500.0) as emu:
        assert emu.transfer(0) == 0.0
        assert emu.transfer(-5) == 0.0
        assert emu.transfers == 0 and emu.bytes_total == 0
        emu.transfer(1000)
        emu.transfer(3000)
        assert emu.transfers == 2
        assert emu.bytes_total == 4000
        assert emu.measured_mbps is not None and emu.measured_mbps > 0


def test_dropped_bytes_raise_loudly():
    """A sink that acks one byte less must raise, never read as a faster
    link; the failed transfer leaves the accounting alone."""
    srv = socket.create_server(("127.0.0.1", 0))
    port = srv.getsockname()[1]

    def lying_sink():
        conn, _ = srv.accept()
        srv.close()
        with conn:
            (length,) = _HDR.unpack(conn.recv(_HDR.size))
            got = 0
            while got < length:
                buf = conn.recv(min(65536, length - got))
                if not buf:
                    return
                got += len(buf)
            conn.sendall(_HDR.pack(got - 1))

    t = threading.Thread(target=lying_sink, daemon=True)
    t.start()
    emu = DCNEmulator(100.0)
    emu._sock = socket.create_connection(("127.0.0.1", port))
    try:
        with pytest.raises(RuntimeError, match="dropped bytes"):
            emu.transfer(10_000)
        assert emu.transfers == 0 and emu.bytes_total == 0
    finally:
        emu._sock.close()
        emu._sock = None
        t.join(timeout=5)


def test_shutdown_clean_and_double_close_safe():
    emu = DCNEmulator(300.0).start()
    proc = emu._proc
    emu.transfer(4096)
    emu.close()
    assert proc.returncode == 0
    emu.close()
    assert emu._sock is None and emu._proc is None


def test_nonpositive_bandwidth_refused():
    with pytest.raises(ValueError, match="> 0 Mbps"):
        DCNEmulator(0.0)
    with pytest.raises(ValueError, match="> 0 Mbps"):
        DCNEmulator(-5.0)

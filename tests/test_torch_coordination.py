"""The port's step channel (runtime/coordination.py): the five cases of
tests/test_coordination.py, and frames exchanged with jlama_tpu's channel in
both directions, byte for byte. The leader binds port 0 and hands the port
it got to the followers (`on_bound`): no port is picked by releasing it."""

import queue
import socket
import struct
import threading

import numpy as np
import pytest

from jlama_tpu.runtime.coordination import StepChannel as JStepChannel
from jlama_tpu_torch.runtime.coordination import (
    StepChannel,
    coordinator_host,
    default_step_port,
    encode_frame,
)

DEADLINE = 30


def _serve_with(n_followers, follower_fns):
    """Start rank 0 on port 0 and one thread per follower function, each
    called with the bound port; returns (channel, threads)."""
    ports: queue.Queue = queue.Queue()

    def run(fn):
        fn(ports.get(timeout=DEADLINE))

    threads = [threading.Thread(target=run, args=(fn,), daemon=True) for fn in follower_fns]
    for t in threads:
        t.start()

    def bound(port):
        for _ in follower_fns:
            ports.put(port)

    srv = StepChannel.serve(0, n_followers, host="127.0.0.1", timeout=DEADLINE, on_bound=bound)
    return srv, threads


def _join(threads):
    for t in threads:
        t.join(timeout=DEADLINE)
        assert not t.is_alive()


def test_fanout_ordering_and_framing():
    n_followers = 3
    received = [[] for _ in range(n_followers)]

    def follower(i):
        def fn(port):
            ch = StepChannel.connect("127.0.0.1", port, timeout=DEADLINE)
            while True:
                msg = ch.next()
                if msg["op"] == "stop":
                    return
                received[i].append(msg)
        return fn

    srv, threads = _serve_with(n_followers, [follower(i) for i in range(n_followers)])
    msgs = [{"op": "decode", "tokens": np.arange(8, dtype=np.int32).reshape(2, 4),
             "win": 128, "depth": k} for k in range(20)]
    for m in msgs:
        srv.publish(m)
    srv.close()  # publishes stop
    _join(threads)
    for r in received:
        assert len(r) == 20
        assert [m["depth"] for m in r] == list(range(20))
        np.testing.assert_array_equal(r[7]["tokens"], msgs[7]["tokens"])


def test_closed_channel_raises():
    got = {}

    def follower(port):
        ch = StepChannel.connect("127.0.0.1", port, timeout=DEADLINE)
        try:
            ch.next()
        except ConnectionError:
            got["err"] = True

    srv, threads = _serve_with(1, [follower])
    for s in srv._socks:  # hard close without the stop message
        s.close()
    _join(threads)
    assert got.get("err"), "follower did not see the closed channel"


def test_address_helpers(monkeypatch):
    monkeypatch.delenv("JLAMA_STEP_PORT", raising=False)
    assert default_step_port("10.0.0.5:8476") == 9476
    assert default_step_port(None) == 8477
    assert coordinator_host("10.0.0.5:8476") == "10.0.0.5"
    assert coordinator_host(None) == "127.0.0.1"
    monkeypatch.setenv("JLAMA_STEP_PORT", "7001")
    assert default_step_port("10.0.0.5:8476") == 7001


def test_heartbeat_timeout_raises(monkeypatch):
    """A silent leader past JLAMA_STEP_TIMEOUT is presumed dead: next()
    raises instead of blocking the follower forever."""
    monkeypatch.setenv("JLAMA_STEP_TIMEOUT", "0.3")
    got = {}

    def follower(port):
        ch = StepChannel.connect("127.0.0.1", port, timeout=DEADLINE)
        try:
            ch.next()
        except ConnectionError as e:
            got["err"] = str(e)

    srv, threads = _serve_with(1, [follower])
    _join(threads)  # the leader stays silent
    assert "leader presumed dead" in got.get("err", ""), got
    srv.close()


def test_publish_to_dead_follower_raises():
    """Losing a follower fails the publish fast (a hung collective would
    otherwise freeze every surviving process)."""
    box = {}

    def follower(port):
        box["ch"] = StepChannel.connect("127.0.0.1", port, timeout=DEADLINE)

    srv, threads = _serve_with(1, [follower])
    _join(threads)
    box["ch"].close()  # the follower dies
    with pytest.raises(ConnectionError, match="follower 1 lost"):
        # the first sends may land in socket buffers; the reset surfaces
        # within a few frames of a closed peer
        for _ in range(1000):
            srv.publish({"op": "ping", "pad": b"x" * 4096})
    with pytest.raises(RuntimeError, match="rank 0"):
        srv.next()


MSGS = [{"op": "prefill", "toks": np.arange(12, dtype=np.int32).reshape(2, 6),
         "pos": np.arange(12, dtype=np.int32).reshape(2, 6), "pt": np.ones((2, 4), np.int32),
         "win": 16},
        {"op": "decode_chain", "depth": 3, "win": 32, "pts": np.zeros((2, 4), np.int32)},
        {"op": "suspend", "sid": "s", "idxs": np.array([3, 4], np.int32), "dir": None}]


def _read_frames(sock, n):
    out = []
    for _ in range(n):
        hdr = JStepChannel._read_exact(sock, 4)
        (size,) = struct.unpack(">I", hdr)
        out.append(hdr + JStepChannel._read_exact(sock, size))
    return out


def _same(a, b):
    assert a.keys() == b.keys()
    for k in a:
        if isinstance(a[k], np.ndarray):
            np.testing.assert_array_equal(a[k], b[k])
        else:
            assert a[k] == b[k]


def _jax_frames():
    """The frames jlama_tpu's leader sends for MSGS."""
    frames = []
    ch = JStepChannel([], is_server=True)
    ch._publish_frame = frames.append
    for m in MSGS:
        ch.publish(m)
    return frames


def test_jax_follower_reads_port_leader():
    """A jlama_tpu follower reads the port's leader, and the bytes on the
    wire are the ones jlama_tpu's leader sends for the same messages."""
    got, raw = [], []

    def jax_follower(port):
        ch = JStepChannel.connect("127.0.0.1", port, timeout=DEADLINE)
        for _ in MSGS:
            got.append(ch.next())

    def raw_reader(port):
        with socket.create_connection(("127.0.0.1", port), timeout=DEADLINE) as s:
            raw.extend(_read_frames(s, len(MSGS)))

    srv, threads = _serve_with(2, [jax_follower, raw_reader])
    for m in MSGS:
        srv.publish(m)
    _join(threads)
    srv.close()
    assert len(got) == len(MSGS)
    for a, b in zip(got, MSGS):
        _same(a, b)
    assert raw == _jax_frames() == [encode_frame(m) for m in MSGS]


def test_port_follower_reads_jax_leader():
    """The port's follower reads a jlama_tpu leader (built over sockets this
    test accepted on a port it bound and keeps), and jlama_tpu's frames are
    the port's bytes."""
    got, raw = [], []
    with socket.socket() as lst:
        lst.bind(("127.0.0.1", 0))
        lst.listen(2)
        lst.settimeout(DEADLINE)
        port = lst.getsockname()[1]

        def follower():
            ch = StepChannel.connect("127.0.0.1", port, timeout=DEADLINE)
            for _ in MSGS:
                got.append(ch.next())

        t = threading.Thread(target=follower, daemon=True)
        t.start()
        conn_f, _ = lst.accept()
        reader = socket.create_connection(("127.0.0.1", port), timeout=DEADLINE)
        conn_r, _ = lst.accept()
    leader = JStepChannel([conn_f, conn_r], is_server=True)
    for m in MSGS:
        leader.publish(m)
    raw.extend(_read_frames(reader, len(MSGS)))
    _join([t])
    leader.close()
    reader.close()
    for a, b in zip(got, MSGS):
        _same(a, b)
    assert len(got) == len(MSGS)
    assert raw == [encode_frame(m) for m in MSGS]

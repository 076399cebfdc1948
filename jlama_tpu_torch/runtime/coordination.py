"""The step channel of multi-process serving (counterpart of
`jlama_tpu/runtime/coordination.py`).

Rank 0 owns the continuous-batching scheduler and the HTTP server; every
other rank runs the follower loop (`BatchScheduler.run_follower`). Each
rank's forward issues the same collectives in the same order, so before
each device call rank 0 sends a small step descriptor (op, numpy inputs,
static arguments, a few KB) over a TCP fan-out channel, and the followers
replay the identical call on their own shards. Activations and the tp
all-reduces go through `torch.distributed`, never through this channel.

Wire format, the JAX package's: a 4-byte big-endian length, then a pickled
dict. The channel runs from rank 0 to the followers only; followers never
send (the collectives are the synchronization). Either package's follower
reads the other's leader.

The port's one addition: `serve` takes port 0 and hands the port it bound
to `on_bound` before it waits for the followers, so that a caller can
publish it (through a `torch.distributed` store, say) and no port is picked
by binding and releasing it.
"""

from __future__ import annotations

import os
import pickle
import socket
import struct
import threading
import time
from typing import Callable


def encode_frame(msg: dict) -> bytes:
    """One message as it goes on the wire: length, then the pickle."""
    blob = pickle.dumps(msg, protocol=pickle.HIGHEST_PROTOCOL)
    return struct.pack(">I", len(blob)) + blob


class StepChannel:
    """Fan-out broadcast channel: rank 0 publishes, followers receive."""

    def __init__(self, socks: list[socket.socket], is_server: bool):
        self._socks = socks
        self._is_server = is_server
        # publish is called from the scheduler loop and from the public
        # session operations, which other threads may call: a lock keeps
        # frames from interleaving
        self._pub_lock = threading.Lock()

    # -- construction --------------------------------------------------

    @classmethod
    def serve(cls, port: int, n_followers: int, host: str = "0.0.0.0",
              timeout: float = 300.0,
              on_bound: Callable[[int], None] | None = None) -> "StepChannel":
        """Rank 0: bind `port` (0: any free port), call `on_bound` with the
        port bound, then accept exactly n_followers connections."""
        srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        socks = []
        try:
            srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            srv.bind((host, port))
            srv.listen(n_followers)
            srv.settimeout(timeout)
            if on_bound is not None:
                on_bound(srv.getsockname()[1])
            for _ in range(n_followers):
                conn, _ = srv.accept()
                conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
                socks.append(conn)
        except BaseException:
            for s in socks:
                s.close()
            raise
        finally:
            srv.close()
        return cls(socks, is_server=True)

    @classmethod
    def connect(cls, host: str, port: int, timeout: float = 300.0) -> "StepChannel":
        """Follower: connect, retrying while rank 0 is still loading.

        The receive side gets a liveness timeout (JLAMA_STEP_TIMEOUT seconds,
        default 900, 0 disables): the leader sends {"op": "ping"} while idle,
        so a leader silent for that long is gone, and next() raises instead
        of hanging the follower."""
        recv_timeout = float(os.environ.get("JLAMA_STEP_TIMEOUT", "900")) or None
        deadline = time.time() + timeout
        last_err: Exception | None = None
        while time.time() < deadline:
            try:
                s = socket.create_connection((host, port), timeout=10)
                s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
                s.settimeout(recv_timeout)
                return cls([s], is_server=False)
            except OSError as e:  # noqa: PERF203
                last_err = e
                time.sleep(0.2)
        raise TimeoutError(f"could not reach step coordinator {host}:{port}: {last_err}")

    # -- wire ----------------------------------------------------------

    def publish(self, msg: dict) -> None:
        if not self._is_server:
            raise RuntimeError("only rank 0 publishes")
        frame = encode_frame(msg)
        with self._pub_lock:
            self._publish_frame(frame)

    def _publish_frame(self, frame: bytes) -> None:
        for i, s in enumerate(self._socks):
            try:
                s.sendall(frame)
            except OSError as e:
                # a dead follower would otherwise hang the next collective
                # forever; fail fast with the rank named
                raise ConnectionError(
                    f"step follower {i + 1} lost ({e}); the cluster is "
                    "degraded — restart all processes to recover"
                ) from e

    def next(self) -> dict:
        if self._is_server:
            raise RuntimeError("rank 0 does not receive")
        s = self._socks[0]
        try:
            hdr = self._read_exact(s, 4)
            (n,) = struct.unpack(">I", hdr)
            return pickle.loads(self._read_exact(s, n))
        except TimeoutError as e:
            raise ConnectionError(
                "no step or heartbeat from the coordinator within "
                "JLAMA_STEP_TIMEOUT — leader presumed dead"
            ) from e

    @staticmethod
    def _read_exact(s: socket.socket, n: int) -> bytes:
        buf = bytearray()
        while len(buf) < n:
            chunk = s.recv(n - len(buf))
            if not chunk:
                raise ConnectionError("step channel closed")
            buf.extend(chunk)
        return bytes(buf)

    def close(self) -> None:
        if self._is_server:
            try:
                self.publish({"op": "stop"})
            except OSError:
                pass
        for s in self._socks:
            try:
                s.close()
            except OSError:
                pass


def default_step_port(coordinator_address: str | None) -> int:
    """Step-channel port: JLAMA_STEP_PORT, else the coordinator's port + 1000."""
    if os.environ.get("JLAMA_STEP_PORT"):
        return int(os.environ["JLAMA_STEP_PORT"])
    if coordinator_address and ":" in coordinator_address:
        return int(coordinator_address.rsplit(":", 1)[1]) + 1000
    return 8477


def coordinator_host(coordinator_address: str | None) -> str:
    if coordinator_address and ":" in coordinator_address:
        return coordinator_address.rsplit(":", 1)[0]
    return "127.0.0.1"

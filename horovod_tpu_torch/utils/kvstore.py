"""Minimal TCP key-value service with the coordinator's client surface.

Counterpart of horovod_tpu/utils/kvstore.py, kept as the JAX package's
standalone server and client: process 0 hosts one server thread, and
every process talks to it through :class:`KVClient`, which implements
the exact four-method surface the coordinator uses:

- ``key_value_set_bytes(key, value, allow_overwrite=...)``
- ``blocking_key_value_get_bytes(key, timeout_ms)`` (raises a
  DEADLINE_EXCEEDED-worded error on expiry)
- ``key_value_try_get_bytes(key)`` (None when missing)
- ``key_value_delete(key)``

The eager engine's sessions ride the process group's own store instead
(utils/store_kv.py); this service is for a control plane with no
process group around it (the JAX package's simulated-rank harness).
The server binds loopback unless told otherwise; it is unauthenticated.

Wire format (one request per connection; values are opaque bytes):
``op(1) keylen(u32) key [set: overwrite(u8) vallen(u64) val |
get: timeout_ms(u32)]`` -> ``status(1) vallen(u64) val`` where status is
``O`` (ok + value), ``N`` (missing / no value), ``A`` (already exists),
``E`` (error, value is the message).
"""

import os
import random
import socket
import socketserver
import struct
import threading
import time

OP_SET = b"S"
OP_GET = b"G"
OP_TRY = b"T"
OP_DEL = b"D"


def _recv_exact(sock, n):
    buf = b""
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise ConnectionError("kvstore: peer closed mid-message")
        buf += chunk
    return buf


class _Store:
    def __init__(self):
        self._d = {}
        self._cond = threading.Condition()

    def set(self, key, value, overwrite):
        with self._cond:
            if not overwrite and key in self._d:
                return False
            self._d[key] = value
            self._cond.notify_all()
            return True

    def get(self, key, timeout_s):
        with self._cond:
            self._cond.wait_for(lambda: key in self._d, timeout=timeout_s)
            return self._d.get(key)

    def try_get(self, key):
        with self._cond:
            return self._d.get(key)

    def delete(self, key):
        with self._cond:
            self._d.pop(key, None)


class _Handler(socketserver.BaseRequestHandler):
    def handle(self):
        sock = self.request
        try:
            op = _recv_exact(sock, 1)
            (klen,) = struct.unpack("!I", _recv_exact(sock, 4))
            key = _recv_exact(sock, klen).decode()
            store = self.server.store
            if op == OP_SET:
                (ow,) = struct.unpack("!B", _recv_exact(sock, 1))
                (vlen,) = struct.unpack("!Q", _recv_exact(sock, 8))
                value = _recv_exact(sock, vlen) if vlen else b""
                ok = store.set(key, value, bool(ow))
                self._reply(sock, b"O" if ok else b"A", b"")
            elif op == OP_GET:
                (tmo,) = struct.unpack("!I", _recv_exact(sock, 4))
                value = store.get(key, tmo / 1000.0)
                if value is None:
                    self._reply(sock, b"N", b"")
                else:
                    self._reply(sock, b"O", value)
            elif op == OP_TRY:
                value = store.try_get(key)
                if value is None:
                    self._reply(sock, b"N", b"")
                else:
                    self._reply(sock, b"O", value)
            elif op == OP_DEL:
                store.delete(key)
                self._reply(sock, b"O", b"")
            else:
                self._reply(sock, b"E", b"unknown op")
        except (ConnectionError, OSError):
            pass

    @staticmethod
    def _reply(sock, status, value):
        sock.sendall(status + struct.pack("!Q", len(value)) + value)


class KVServer:
    """Process-lifetime KV service (daemon threads; dies with the host
    process, which is the same availability contract the in-process
    coordination service has)."""

    def __init__(self, bind="127.0.0.1", port=0, backlog=None):
        # socketserver's default listen backlog is 5 — at one connection
        # per request, a pod-scale fan-in (hundreds of simulated ranks
        # publishing in one burst, controlplane/simrank.py) overflows it
        # and the kernel refuses connections. The backlog is cheap;
        # default it high enough for any realistic burst.
        self._server = socketserver.ThreadingTCPServer(
            (bind, port), _Handler, bind_and_activate=False)
        self._server.request_queue_size = 512 if backlog is None \
            else int(backlog)
        try:
            self._server.server_bind()
            self._server.server_activate()
        except Exception:
            self._server.server_close()
            raise
        self._server.daemon_threads = True
        self._server.store = _Store()
        self.port = self._server.server_address[1]
        self._thread = threading.Thread(
            target=self._server.serve_forever, name="hvd-tpu-kvstore",
            daemon=True)
        self._thread.start()

    def close(self):
        self._server.shutdown()
        self._server.server_close()


class KVClient:
    """One-connection-per-request client; method-for-method compatible
    with the KV client surface the coordinator uses."""

    def __init__(self, address, connect_timeout=10.0, retries=None,
                 retry_base_seconds=None, rst_close=False):
        host, _, port = address.rpartition(":")
        self._addr = (host, int(port))
        self._connect_timeout = connect_timeout
        # RST-close: skip TIME_WAIT by sending a reset on close
        # (SO_LINGER 1,0). One-connection-per-request means a busy
        # client parks thousands of sockets in TIME_WAIT and exhausts
        # ephemeral ports — fatal for the simulated-rank harness, which
        # multiplexes whole pods of clients onto one host. Off by
        # default: real jobs never reach that churn, and an RST can drop
        # a reply still in flight on exotic stacks.
        self._rst_close = bool(rst_close)
        # Bounded connection retry (docs/robustness.md): a control-plane
        # server briefly unreachable (restarting accept queue, SYN drop
        # under churn) should cost a jittered backoff, not the job.
        # Connection ESTABLISHMENT only — a request is never resent, so
        # non-idempotent ops (allow_overwrite=False sets) keep their
        # exactly-once semantics, and blocking-get DEADLINE_EXCEEDED
        # classification (coordinator._is_timeout_error) is untouched.
        if retries is None or retry_base_seconds is None:
            from ..config import Config
            cfg = Config.from_env()
            if retries is None:
                retries = cfg.kv_retries
            if retry_base_seconds is None:
                retry_base_seconds = cfg.kv_retry_base_seconds
        self._retries = max(int(retries), 0)
        self._retry_base = float(retry_base_seconds)

    def _connect(self):
        attempt = 0
        while True:
            try:
                return socket.create_connection(
                    self._addr, timeout=self._connect_timeout)
            except OSError:
                attempt += 1
                if attempt > self._retries:
                    raise
                delay = (self._retry_base * (2 ** (attempt - 1))
                         * (1.0 + random.random()))
                from .. import metrics
                metrics.KV_RETRIES.inc()
                time.sleep(delay)

    def _call(self, payload, timeout_s):
        with self._connect() as sock:
            if self._rst_close:
                sock.setsockopt(socket.SOL_SOCKET, socket.SO_LINGER,
                                struct.pack("ii", 1, 0))
            sock.settimeout(timeout_s)
            sock.sendall(payload)
            status = _recv_exact(sock, 1)
            (vlen,) = struct.unpack("!Q", _recv_exact(sock, 8))
            value = _recv_exact(sock, vlen) if vlen else b""
            return status, value

    @staticmethod
    def _key(key):
        kb = key.encode()
        return struct.pack("!I", len(kb)) + kb

    def key_value_set_bytes(self, key, value, allow_overwrite=False):
        value = bytes(value)
        payload = (OP_SET + self._key(key)
                   + struct.pack("!B", 1 if allow_overwrite else 0)
                   + struct.pack("!Q", len(value)) + value)
        status, msg = self._call(payload, self._connect_timeout)
        if status == b"A":
            raise RuntimeError(
                f"ALREADY_EXISTS: key {key} already set "
                f"(allow_overwrite=False)")
        if status != b"O":
            raise RuntimeError(f"INTERNAL: kvstore set failed: {msg!r}")

    def blocking_key_value_get_bytes(self, key, timeout_in_ms):
        payload = OP_GET + self._key(key) + struct.pack(
            "!I", int(timeout_in_ms))
        status, value = self._call(
            payload, timeout_in_ms / 1000.0 + self._connect_timeout)
        if status == b"N":
            # Wording matters: callers classify timeouts by the gRPC
            # status token (coordinator._is_timeout_error).
            raise RuntimeError(
                f"DEADLINE_EXCEEDED: kvstore get timed out for key "
                f"{key} after {timeout_in_ms}ms")
        if status != b"O":
            raise RuntimeError(f"INTERNAL: kvstore get failed: {value!r}")
        return value

    def key_value_try_get_bytes(self, key):
        status, value = self._call(OP_TRY + self._key(key),
                                   self._connect_timeout)
        return value if status == b"O" else None

    def key_value_delete(self, key):
        self._call(OP_DEL + self._key(key), self._connect_timeout)

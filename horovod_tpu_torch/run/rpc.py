"""HMAC-authenticated pickle-over-TCP RPC micro-framework.

Counterpart of horovod_tpu/run/rpc.py, copied (plain Python).

Reference equivalent: horovod/run/common/util/network.py (``Wire`` HMAC +
cloudpickle framing :49-83, threaded ``BasicService``/``BasicClient`` with
random port binding and multi-interface addresses :86+, Ping/Ack for
interface probing) plus run/common/util/secret.py (HMAC keys) and codec.py
(base64 pickle codec).

The wire format differs from the reference only in the serializer (stdlib
pickle instead of cloudpickle — nothing we ship over the wire needs code
pickling except Spark's user fn, which routes through :func:`dumps_base64`
where dill/cloudpickle is picked up when importable). Every frame is
authenticated: a 32-byte HMAC-SHA256 digest over the payload, keyed by the
per-job secret, precedes each length-prefixed pickle blob; a bad digest
raises :class:`AuthenticationError` before any unpickling happens, same
defense the reference relies on.
"""

import base64
import hashlib
import hmac
import io
import pickle
import secrets as _secrets
import socket
import socketserver
import struct
import threading
import time

_LEN = struct.Struct("<Q")
_DIGEST_BYTES = 32
# Frames are control-plane messages (registrations, command lines, output
# lines); cap them so an unauthenticated peer can't OOM the service by
# declaring a huge length before the digest check runs.
MAX_FRAME_BYTES = 64 * 1024 * 1024


def make_secret_key():
    """Per-job HMAC key (reference: run/common/util/secret.py:22)."""
    return _secrets.token_bytes(32)


class AuthenticationError(Exception):
    """Frame failed HMAC verification."""


class Wire:
    """Length-prefixed, HMAC-authenticated pickle framing.

    Reference: network.py:49-83 — same structure (digest + payload), with
    the digest checked before deserialization.
    """

    def __init__(self, key):
        self._key = key

    def write(self, obj, wfile):
        payload = pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL)
        digest = hmac.new(self._key, payload, hashlib.sha256).digest()
        wfile.write(_LEN.pack(len(payload)))
        wfile.write(digest)
        wfile.write(payload)
        wfile.flush()

    def read(self, rfile):
        header = self._read_exact(rfile, _LEN.size)
        (length,) = _LEN.unpack(header)
        if length > MAX_FRAME_BYTES:
            raise AuthenticationError(
                f"Frame length {length} exceeds the {MAX_FRAME_BYTES}-byte "
                f"limit; dropping peer.")
        digest = self._read_exact(rfile, _DIGEST_BYTES)
        payload = self._read_exact(rfile, length)
        expected = hmac.new(self._key, payload, hashlib.sha256).digest()
        if not hmac.compare_digest(digest, expected):
            raise AuthenticationError(
                "Message digest does not match; possibly a different "
                "secret key or a tampered message.")
        return pickle.loads(payload)

    @staticmethod
    def _read_exact(rfile, n):
        buf = io.BytesIO()
        while buf.tell() < n:
            chunk = rfile.read(n - buf.tell())
            if not chunk:
                raise EOFError("Connection closed mid-frame.")
            buf.write(chunk)
        return buf.getvalue()


class PingRequest:
    pass


class PingResponse:
    def __init__(self, service_name):
        self.service_name = service_name


class AckResponse:
    pass


def local_addresses():
    """Reachable IPv4 addresses of this host: primary outbound interface
    first, then other non-loopback addresses, loopback last.

    The reference enumerates NICs via psutil (run/util/network.py) to let
    clients race every interface. Loopback must sort last: on hosts where
    /etc/hosts maps the hostname to 127.0.1.1, getaddrinfo returns only
    loopback and a service advertising that first would be unreachable
    from every other host. The UDP connect trick finds the primary
    outbound interface without sending any packet.
    """
    addrs = []
    try:
        with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as s:
            s.connect(("10.255.255.255", 1))  # no packet is sent
            addrs.append(s.getsockname()[0])
    except OSError:
        pass
    try:
        for info in socket.getaddrinfo(socket.gethostname(), None,
                                       socket.AF_INET):
            ip = info[4][0]
            if ip not in addrs and not ip.startswith("127."):
                addrs.append(ip)
    except socket.gaierror:
        pass
    addrs.append("127.0.0.1")
    return addrs


class BasicService:
    """Threaded TCP server answering authenticated pickled requests.

    Reference: network.py ``BasicService`` — random port, one thread per
    connection, ``_handle`` dispatch, Ping answered by every service.
    """

    def __init__(self, service_name, key):
        self._service_name = service_name
        self._wire = Wire(key)
        self._conns = set()
        self._conns_lock = threading.Lock()
        outer = self

        class _Handler(socketserver.BaseRequestHandler):
            def handle(self):
                with outer._conns_lock:
                    outer._conns.add(self.request)
                rfile = self.request.makefile("rb")
                wfile = self.request.makefile("wb")
                try:
                    while True:
                        try:
                            req = outer._wire.read(rfile)
                        except (EOFError, ConnectionError, OSError):
                            break
                        resp = outer._dispatch(req, self.client_address)
                        outer._wire.write(resp, wfile)
                except AuthenticationError:
                    return  # drop unauthenticated peers silently
                finally:
                    with outer._conns_lock:
                        outer._conns.discard(self.request)
                    rfile.close()
                    wfile.close()

        class _Server(socketserver.ThreadingTCPServer):
            daemon_threads = True
            allow_reuse_address = True

        self._server = _Server(("0.0.0.0", 0), _Handler)
        self._port = self._server.server_address[1]
        self._thread = threading.Thread(target=self._server.serve_forever,
                                        daemon=True)
        self._thread.start()

    def _dispatch(self, req, client_address):
        if isinstance(req, PingRequest):
            return PingResponse(self._service_name)
        return self._handle(req, client_address)

    def _handle(self, req, client_address):
        raise NotImplementedError(
            f"{self._service_name}: unknown request {type(req).__name__}")

    @property
    def port(self):
        return self._port

    def addresses(self):
        return [(ip, self._port) for ip in local_addresses()]

    def shutdown(self):
        self._server.shutdown()
        self._server.server_close()
        # Drop live peer connections too, so clients observe the service as
        # gone (daemon handler threads would otherwise keep answering —
        # defeating e.g. task_fn's driver-liveness probe).
        with self._conns_lock:
            conns = list(self._conns)
        for sock in conns:
            try:
                sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                sock.close()
            except OSError:
                pass
        self._thread.join(timeout=5)


class BasicClient:
    """Client racing a service's addresses; verifies the service name.

    Reference: network.py ``BasicClient`` — probes every advertised
    (interface, port) with a Ping and keeps the first that answers with
    the expected service name.
    """

    def __init__(self, service_name, addresses, key, probe_timeout=5,
                 attempts=3):
        self._service_name = service_name
        self._wire = Wire(key)
        self._lock = threading.Lock()
        self._sock = None
        self._rfile = None
        self._wfile = None
        self._addr = self._probe(addresses, probe_timeout, attempts)

    def _probe(self, addresses, timeout, attempts):
        last_err = None
        for _ in range(attempts):
            for addr in addresses:
                try:
                    resp = self._request_once(addr, PingRequest(), timeout)
                    if (isinstance(resp, PingResponse)
                            and resp.service_name == self._service_name):
                        return addr
                except (OSError, EOFError, AuthenticationError) as e:
                    last_err = e
            time.sleep(0.2)
        raise ConnectionError(
            f"Unable to connect to the {self._service_name} on any of "
            f"{addresses}: {last_err}")

    def _request_once(self, addr, req, timeout=None):
        with socket.create_connection(addr, timeout=timeout) as sock:
            rfile = sock.makefile("rb")
            wfile = sock.makefile("wb")
            try:
                self._wire.write(req, wfile)
                return self._wire.read(rfile)
            finally:
                rfile.close()
                wfile.close()

    def _connect(self):
        self._sock = socket.create_connection(self._addr)
        self._rfile = self._sock.makefile("rb")
        self._wfile = self._sock.makefile("wb")

    def _disconnect(self):
        for f in (self._rfile, self._wfile, self._sock):
            if f is not None:
                try:
                    f.close()
                except OSError:
                    pass
        self._sock = self._rfile = self._wfile = None

    def request(self, req, idempotent=True):
        """Send over one persistent connection (the server's handler loop
        keeps reading frames); reconnect once on a broken pipe.

        A retry after the frame may already have been delivered (failure
        while awaiting the response) only happens for ``idempotent``
        requests — non-idempotent ones (e.g. RunCommand) raise instead of
        risking double execution.
        """
        with self._lock:
            for attempt in (0, 1):
                sent = False
                try:
                    if self._sock is None:
                        self._connect()
                    self._wire.write(req, self._wfile)
                    sent = True
                    return self._wire.read(self._rfile)
                except (OSError, EOFError) as e:
                    self._disconnect()
                    if attempt or (sent and not idempotent):
                        raise ConnectionError(
                            f"Lost connection to the {self._service_name} "
                            f"at {self._addr}: {e}") from e

    def close(self):
        with self._lock:
            self._disconnect()

    @property
    def address(self):
        return self._addr


def dumps_base64(obj):
    """Reference: run/common/util/codec.py — base64(pickle(obj)).

    Uses cloudpickle/dill when importable so closures (Spark user fns)
    survive; plain pickle otherwise.
    """
    try:
        import cloudpickle as pickler
    except ImportError:
        try:
            import dill as pickler
        except ImportError:
            pickler = pickle
    return base64.b64encode(pickler.dumps(obj)).decode("ascii")


def loads_base64(data):
    raw = base64.b64decode(data)
    try:
        return pickle.loads(raw)
    except Exception:
        import dill  # dill-serialized closures need dill to load
        return dill.loads(raw)


class Timeout:
    """Deadline helper with the reference's error style
    (run/common/util/timeout.py)."""

    def __init__(self, timeout, message):
        self._deadline = time.time() + timeout
        self._message = message
        self._timeout = timeout

    def remaining(self):
        return max(0.0, self._deadline - time.time())

    def check(self):
        if time.time() > self._deadline:
            raise TimeoutError(
                self._message.format(timeout=self._timeout))

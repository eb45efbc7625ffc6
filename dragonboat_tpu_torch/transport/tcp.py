"""TCP transport: framed MessageBatch + snapshot chunk streams over sockets.

Parity with the reference's TCP module (``internal/transport/tcp.go``):
a length+CRC framed request header (:64-110) in front of each payload, a
method field separating raft batches (100) from snapshot chunks (200), a
listener spawning one reader per accepted connection, and cached outbound
connections per target.  Payload integrity rides the application-layer CRCs
already inside raftpb's wire encodings (the header carries its own CRC and
a payload CRC, mirroring requestHeader).
"""

from __future__ import annotations

import socket
import ssl
import struct
import threading
import zlib

from dragonboat_tpu_torch import raftpb as pb
from dragonboat_tpu_torch.raftio import IConnection, ISnapshotConnection, ITransport

RAFT_TYPE = 100
SNAPSHOT_TYPE = 200
_REQ_HDR = struct.Struct(">HQII")     # method, size, header-crc, payload-crc
MAX_FRAME = 1 << 30
# the reference's per-request preamble (tcp.go:43-44): 2 magic bytes
# before every header; the all-zero poison announces a clean close
GO_MAGIC = b"\xae\x7d"
GO_POISON = b"\x00\x00"


def _encode_header(method: int, payload: bytes) -> bytes:
    """requestHeader.encode (tcp.go:79-90): crc field zeroed while hashing."""
    pcrc = zlib.crc32(payload)
    raw = _REQ_HDR.pack(method, len(payload), 0, pcrc)
    hcrc = zlib.crc32(raw)
    return _REQ_HDR.pack(method, len(payload), hcrc, pcrc)


def _decode_header(raw: bytes) -> tuple[int, int, int]:
    method, size, hcrc, pcrc = _REQ_HDR.unpack(raw)
    expected = zlib.crc32(_REQ_HDR.pack(method, size, 0, pcrc))
    if hcrc != expected:
        raise ValueError("request header crc mismatch")
    if method not in (RAFT_TYPE, SNAPSHOT_TYPE):
        raise ValueError(f"invalid method {method}")
    if size > MAX_FRAME:
        raise ValueError("frame too large")
    return method, size, pcrc


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    buf = bytearray()
    while len(buf) < n:
        part = sock.recv(n - len(buf))
        if not part:
            raise ConnectionError("peer closed")
        buf += part
    return bytes(buf)


def _send_frame(sock: socket.socket, method: int, payload: bytes) -> None:
    sock.sendall(_encode_header(method, payload) + payload)


class _TCPConn:
    """Cached outbound connection (TCPConnection, tcp.go:298)."""

    def __init__(self, target: str,
                 client_ctx: ssl.SSLContext | None = None,
                 wire: str = "native") -> None:
        self.wire = wire
        host, port = target.rsplit(":", 1)
        sock = socket.create_connection((host, int(port)), timeout=5)
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        if client_ctx is not None:
            # mutual TLS (tcp.go getConnection → tls.Dial with the client
            # certificate; the server name is not checked — the CA is the
            # trust anchor, matching MutualTLS semantics)
            sock = client_ctx.wrap_socket(sock, server_hostname=host)
        self.sock = sock
        self.mu = threading.Lock()

    def close(self) -> None:
        if self.wire == "go":
            # clean-close handshake (tcp.go sendPoison): a reference
            # peer distinguishes shutdown from a dropped connection
            try:
                with self.mu:
                    self.sock.sendall(GO_POISON)
            except OSError:
                pass
        try:
            self.sock.close()
        except OSError:
            pass

    def send_message_batch(self, batch: pb.MessageBatch) -> None:
        with self.mu:
            if self.wire == "go":
                from dragonboat_tpu_torch.raftpb import gowire

                payload = gowire.encode_message_batch(
                    batch.requests, batch.deployment_id,
                    batch.source_address,
                    # a real Go receiver REJECTS BinVer != 210
                    # (transport.go:312); the hub builds batches with
                    # the default 0
                    batch.bin_ver or gowire.TRANSPORT_BIN_VERSION,
                    # fabric trace header rides as an optional field a
                    # reference peer's _skip_field ignores
                    fabric=(pb.encode_fabric_header(batch.fabric)
                            if batch.fabric is not None else None))
                # one buffer, one syscall: with TCP_NODELAY a separate
                # magic write would emit its own 2-byte segment per batch
                self.sock.sendall(GO_MAGIC +
                                  _encode_header(RAFT_TYPE, payload) +
                                  payload)
            else:
                _send_frame(self.sock, RAFT_TYPE,
                            pb.encode_message_batch(batch))

    def send_chunk(self, chunk) -> None:
        if self.wire == "go":
            # reference snapshot framing (tcp.go:373): the same
            # magic+header preamble with method=200 per chunk, payload
            # a gogo-marshaled pb.Chunk (gowire.GoChunk here — the hub
            # splits with split_snapshot_message_go on this wire)
            from dragonboat_tpu_torch.raftpb import gowire

            if not isinstance(chunk, gowire.GoChunk):
                raise TypeError(
                    "go-wire transport sends gowire.GoChunk records")
            payload = gowire.encode_chunk(chunk)
            with self.mu:
                self.sock.sendall(GO_MAGIC +
                                  _encode_header(SNAPSHOT_TYPE, payload) +
                                  payload)
            return
        with self.mu:
            _send_frame(self.sock, SNAPSHOT_TYPE, pb.encode_chunk(chunk))


class _ConnProxy(IConnection):
    """Hands a cached connection back to the hub; evicts it on failure so
    the next send re-dials (the hub's breaker paces the retries)."""

    def __init__(self, transport: "TCPTransport", target: str) -> None:
        self.transport = transport
        self.target = target

    def close(self) -> None:
        pass

    def _call(self, fn_name: str, arg) -> None:
        if self.transport.partitioned:
            raise ConnectionError(f"{self.transport.addr} partitioned")
        conn = self.transport._conn(self.target)
        try:
            getattr(conn, fn_name)(arg)
        except Exception:
            self.transport._evict(self.target, conn)
            raise

    def send_message_batch(self, batch: pb.MessageBatch) -> None:
        self._call("send_message_batch", batch)

    def send_chunk(self, chunk) -> None:
        if isinstance(chunk, dict):   # chan-transport dict shape
            m = chunk.get("message")
            raise ValueError("tcp transport requires pb.Chunk, got dict "
                             f"(message={m is not None})")
        self._call("send_chunk", chunk)


class TCPTransport(ITransport):
    """Listener + connection cache (NewTCPTransport, tcp.go:394)."""

    def __init__(self, addr: str, message_handler, chunk_handler,
                 listen_addr: str = "",
                 server_ctx: ssl.SSLContext | None = None,
                 client_ctx: ssl.SSLContext | None = None,
                 wire: str = "native") -> None:
        if wire not in ("native", "go"):
            raise ValueError(f"unknown wire {wire!r}")
        self.wire = wire
        self.addr = addr
        # ListenAddress (config.go): where to bind; RaftAddress is what is
        # advertised to peers (NAT / 0.0.0.0 binds)
        self.listen_addr = listen_addr or addr
        self.server_ctx = server_ctx
        self.client_ctx = client_ctx
        self.message_handler = message_handler
        self.chunk_handler = chunk_handler
        # chaos-parity with ChanTransport: while True, inbound frames are
        # read-and-discarded and outbound sends fail (partition_node)
        self.partitioned = False
        self.mu = threading.Lock()
        self.conns: dict[str, _TCPConn] = {}               # guarded-by: mu
        self.running = False
        self._listener: socket.socket | None = None
        self._accepted: set[socket.socket] = set()         # guarded-by: mu

    def name(self) -> str:
        return ("tcp-transport" if self.wire == "native"
                else "go-tcp-transport")

    def start(self) -> None:
        host, port = self.listen_addr.rsplit(":", 1)
        s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        s.bind((host, int(port)))
        s.listen(128)
        self._listener = s
        self.running = True
        threading.Thread(target=self._accept_main,
                         name=f"tcp-accept-{self.addr}", daemon=True).start()

    def close(self) -> None:
        self.running = False
        if self._listener is not None:
            try:
                self._listener.close()
            except OSError:
                pass
        with self.mu:
            for c in self.conns.values():
                c.close()
            self.conns.clear()
            accepted, self._accepted = self._accepted, set()
        for sock in accepted:   # unblock reader threads stuck in recv()
            try:
                sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                sock.close()
            except OSError:
                pass

    def _accept_main(self) -> None:
        while self.running:
            try:
                sock, _ = self._listener.accept()
            except OSError:
                return
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            with self.mu:
                self._accepted.add(sock)
            threading.Thread(target=self._read_main, args=(sock,),
                             daemon=True).start()

    def _read_main(self, sock: socket.socket) -> None:
        """Per-connection reader (tcp.go read loop).  The TLS handshake
        happens HERE, per connection with a timeout — in the accept loop a
        stalled client would block every other peer's inbound path."""
        try:
            if self.server_ctx is not None:
                plain = sock
                try:
                    sock.settimeout(10.0)
                    sock = self.server_ctx.wrap_socket(sock,
                                                       server_side=True)
                    sock.settimeout(None)
                except (ssl.SSLError, OSError):
                    return
                finally:
                    if sock is plain:   # handshake failed
                        with self.mu:
                            self._accepted.discard(plain)
                        try:
                            plain.close()
                        except OSError:
                            pass
                    else:               # track the wrapped socket instead
                        with self.mu:
                            self._accepted.discard(plain)
                            self._accepted.add(sock)
            while self.running:
                if self.wire == "go":
                    # per-request preamble (tcp.go readMagicNumber):
                    # magic continues, poison is a clean close
                    pre = _recv_exact(sock, 2)
                    if pre == GO_POISON:
                        # ack the poison (tcp.go:507 sendPoisonAck) —
                        # a reference peer blocks in waitPoisonAck for
                        # its deadline on every clean close otherwise
                        try:
                            sock.sendall(GO_POISON)
                        except OSError:
                            pass
                        break
                    if pre != GO_MAGIC:
                        raise ValueError("bad magic")
                raw = _recv_exact(sock, _REQ_HDR.size)
                method, size, pcrc = _decode_header(raw)
                payload = _recv_exact(sock, size)
                if zlib.crc32(payload) != pcrc:
                    raise ValueError("payload crc mismatch")
                if self.partitioned:
                    continue
                if method == SNAPSHOT_TYPE and self.wire == "go":
                    # a reference peer's snapshot stream: decode the
                    # gogo-marshaled Chunk and hand it to the chunk
                    # sink's go-wire reassembler (ChunkSink.add
                    # dispatches on the record type)
                    from dragonboat_tpu_torch.raftpb import gowire

                    self.chunk_handler(gowire.decode_chunk(payload))
                    continue
                if method == RAFT_TYPE:
                    if self.wire == "go":
                        from dragonboat_tpu_torch.raftpb import gowire

                        reqs, dep, src, ver, fab = \
                            gowire.decode_message_batch(payload)
                        batch = pb.MessageBatch(
                            requests=reqs, deployment_id=dep,
                            source_address=src, bin_ver=ver,
                            # None for an absent blob or an unknown
                            # header version (old/new peer — drop it)
                            fabric=(pb.decode_fabric_header(fab)
                                    if fab is not None else None))
                    else:
                        batch = pb.decode_message_batch(payload)
                    self.message_handler(batch)
                else:
                    self.chunk_handler(pb.decode_chunk(payload))
        except (ConnectionError, ValueError, OSError):
            pass
        finally:
            with self.mu:
                self._accepted.discard(sock)
            try:
                sock.close()
            except OSError:
                pass

    # -- outbound --------------------------------------------------------

    def _conn(self, target: str) -> _TCPConn:
        with self.mu:
            c = self.conns.get(target)
            if c is None:
                c = self.conns[target] = _TCPConn(target, self.client_ctx,
                                                  wire=self.wire)
            return c

    def _evict(self, target: str, conn: _TCPConn) -> None:
        with self.mu:
            if self.conns.get(target) is conn:
                del self.conns[target]
        conn.close()

    def get_connection(self, target: str) -> IConnection:
        return _ConnProxy(self, target)

    def get_snapshot_connection(self, target: str) -> ISnapshotConnection:
        return _ConnProxy(self, target)


def _tls_contexts(nhconfig):
    """Mutual-TLS contexts from NodeHostConfig (config.go MutualTLS +
    CAFile/CertFile/KeyFile): both sides present certificates signed by
    the shared CA and require the peer to do the same."""
    if not nhconfig.mutual_tls:
        return None, None
    server = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
    server.load_cert_chain(nhconfig.cert_file, nhconfig.key_file)
    server.load_verify_locations(nhconfig.ca_file)
    server.verify_mode = ssl.CERT_REQUIRED
    client = ssl.SSLContext(ssl.PROTOCOL_TLS_CLIENT)
    client.load_cert_chain(nhconfig.cert_file, nhconfig.key_file)
    client.load_verify_locations(nhconfig.ca_file)
    # full verification incl. the server identity (config.go:727 sets
    # ServerName = target host): node certificates must carry the host
    # in their SANs — a compromised key for one identity must not let
    # its holder impersonate every other peer
    client.check_hostname = True
    client.verify_mode = ssl.CERT_REQUIRED
    return server, client


class TCPTransportFactory:
    """config.TransportFactory for real sockets (DefaultTransportFactory).

    ``wire="go"`` makes every connection speak the reference's exact
    byte format — the 2-byte magic preamble + 18-byte crc'd request
    header (tcp.go:43,64-110) around a gogo-protobuf MessageBatch
    (raftpb/gowire.py) — so a host can exchange raft traffic with
    reference hosts over DCN.  Snapshot streaming interops too: method
    200 requests carry reference-layout Chunks both ways (gowire
    GoChunk + chunks.py split_snapshot_message_go/GoChunkSink), with
    SM images transcoded at the fleet boundary (rsm/gosnapshot.py):
    reference container + re-banked sessions outbound — in flight for
    live streams (GoStreamTranscoder), whole-image for file catchup —
    and naturalized inbound before recovery.  File catchup, on-disk
    live streams and witness heals all interop in both directions."""

    def __init__(self, wire: str = "native") -> None:
        self.wire = wire

    def create(self, nhconfig, message_handler, chunk_handler) -> TCPTransport:
        server_ctx, client_ctx = _tls_contexts(nhconfig)
        return TCPTransport(nhconfig.raft_address, message_handler,
                            chunk_handler,
                            listen_addr=nhconfig.listen_address,
                            server_ctx=server_ctx, client_ctx=client_ctx,
                            wire=self.wire)

    def validate(self, addr: str) -> bool:
        try:
            host, port = addr.rsplit(":", 1)
            return 0 < int(port) < 65536 and bool(host)
        except ValueError:
            return False

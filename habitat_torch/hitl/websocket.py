"""A small RFC 6455 websocket server and client, standard library only.

The HITL ``NetworkingServer`` serves keyframes to remote (Unity/VR) clients
over a websocket; the JAX package takes the transport from the
``websockets`` package (``habitat_tpu/hitl/hitl_main.py:382``, ``:479``),
which the card's machine does not have. This module is that transport, with
what a session uses and nothing more:

- the opening handshake (``Sec-WebSocket-Accept`` from ``hashlib.sha1`` and
  ``base64``; no extension or subprotocol is negotiated);
- text frames with 7-, 16- and 64-bit payload lengths (a binary message
  closes the connection with 1003);
- masked client frames (an unmasked one fails the connection with 1002),
  fragmented messages, control frames between fragments;
- ping and pong, and the close handshake.

``serve(handler, host, port)`` is an async context manager on ``asyncio``
streams: each accepted connection is handed to ``handler(conn)`` as a
``ServerConnection`` (``await send(text)``, ``await recv(timeout)``, which
raises ``TimeoutError``, ``await close()``) and is closed when the handler
returns. ``connect(uri)`` is a blocking client (``ClientConnection`` with
``send``, ``recv(timeout)``, ``ping`` and ``close``) for scripts and tests.
A peer that closes, or a connection failed for a protocol error, raises
``ConnectionClosed``.
"""

from __future__ import annotations

import asyncio
import base64
import hashlib
import os
import select
import socket
import struct
import time
from typing import Callable, List, Optional, Tuple
from urllib.parse import urlparse

GUID = "258EAFA5-E914-47DA-95CA-C5AB0DC85B11"
OP_CONT, OP_TEXT, OP_BINARY, OP_CLOSE, OP_PING, OP_PONG = 0x0, 0x1, 0x2, 0x8, 0x9, 0xA
CLOSE_NORMAL, CLOSE_PROTOCOL_ERROR, CLOSE_UNSUPPORTED = 1000, 1002, 1003
MAX_MESSAGE = 64 << 20  # bytes of one message, reassembled


class ConnectionClosed(Exception):
    """The connection is closed: ``code`` and ``reason`` of the close frame
    (1006 when the stream ended without one)."""

    def __init__(self, code: int = 1006, reason: str = ""):
        super().__init__(f"websocket closed: {code} {reason}".rstrip())
        self.code, self.reason = code, reason


class ProtocolError(Exception):
    """A frame the peer may not send; ``code`` is the close code it earns."""

    def __init__(self, msg: str, code: int = CLOSE_PROTOCOL_ERROR):
        super().__init__(msg)
        self.code = code


def accept_key(key: str) -> str:
    """``Sec-WebSocket-Accept`` for a client's ``Sec-WebSocket-Key``."""
    return base64.b64encode(hashlib.sha1((key + GUID).encode()).digest()).decode()


def encode_frame(opcode: int, payload: bytes, mask: bool = False) -> bytes:
    """One whole frame; a client masks its frames with a fresh 4-byte key."""
    n = len(payload)
    head = bytes([0x80 | opcode])
    mbit = 0x80 if mask else 0
    if n < 126:
        head += bytes([mbit | n])
    elif n < 1 << 16:
        head += bytes([mbit | 126]) + struct.pack("!H", n)
    else:
        head += bytes([mbit | 127]) + struct.pack("!Q", n)
    if not mask:
        return head + payload
    key = os.urandom(4)
    return head + key + _unmask(payload, key)


def _unmask(payload: bytes, key: bytes) -> bytes:
    n = len(payload)
    if n == 0:
        return payload
    k = int.from_bytes((key * (n // 4 + 1))[:n], "little")
    return (int.from_bytes(payload, "little") ^ k).to_bytes(n, "little")


def close_payload(code: int, reason: str = "") -> bytes:
    return struct.pack("!H", code) + reason.encode()[:123]


def parse_close(payload: bytes) -> Tuple[int, str]:
    if len(payload) >= 2:
        return struct.unpack("!H", payload[:2])[0], payload[2:].decode(errors="replace")
    return 1005, ""


class _Assembler:
    """Frames in, whole text messages out: checks the frame rules both ends
    share and reassembles fragments."""

    def __init__(self, expect_masked: bool):
        self.expect_masked = expect_masked
        self._parts: Optional[List[bytes]] = None  # a fragmented message in progress
        self._size = 0

    def check_header(self, b0: int, b1: int) -> Tuple[bool, int, int]:
        fin, opcode, masked, n7 = bool(b0 & 0x80), b0 & 0x0F, bool(b1 & 0x80), b1 & 0x7F
        if b0 & 0x70:
            raise ProtocolError("reserved bits set (no extension was negotiated)")
        if masked != self.expect_masked:
            raise ProtocolError("client frames must be masked" if self.expect_masked
                                else "server frames must not be masked")
        if opcode >= 0x8:
            if not fin or n7 > 125:
                raise ProtocolError("control frames must be whole and at most 125 bytes")
        elif opcode == OP_BINARY:
            raise ProtocolError("binary messages are not part of the session", CLOSE_UNSUPPORTED)
        elif opcode not in (OP_CONT, OP_TEXT):
            raise ProtocolError(f"unknown opcode {opcode:#x}")
        return fin, opcode, n7

    def data_frame(self, fin: bool, opcode: int, payload: bytes) -> Optional[str]:
        """The message a data frame completes, or None."""
        if (opcode == OP_CONT) != (self._parts is not None):
            raise ProtocolError("continuation frame without a message" if opcode == OP_CONT
                                else "new message before the last one's final fragment")
        parts = (self._parts or []) + [payload]
        self._size += len(payload)
        if self._size > MAX_MESSAGE:
            raise ProtocolError("message too big")
        if not fin:
            self._parts = parts
            return None
        self._parts, self._size = None, 0
        try:
            return b"".join(parts).decode("utf-8")
        except UnicodeDecodeError as e:
            raise ProtocolError(f"text message is not UTF-8: {e}") from None


# -- server (asyncio streams) ---------------------------------------------


class ServerConnection:
    """One accepted client. A reader task takes frames off the stream as
    they come: it answers pings and a close, reassembles fragments and
    queues whole messages, so that a ``recv`` that times out loses nothing."""

    def __init__(self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter):
        self._reader, self._writer = reader, writer
        self._messages: asyncio.Queue = asyncio.Queue()
        self._closed: Optional[ConnectionClosed] = None
        self._close_sent = False
        self._write_lock = asyncio.Lock()
        self._reader_task = asyncio.get_running_loop().create_task(self._read_loop())

    async def _write(self, frame: bytes) -> None:
        async with self._write_lock:
            self._writer.write(frame)
            await self._writer.drain()

    async def _read_frame(self, asm: _Assembler) -> Tuple[bool, int, bytes]:
        b0, b1 = await self._reader.readexactly(2)
        fin, opcode, n = asm.check_header(b0, b1)
        if n == 126:
            n = struct.unpack("!H", await self._reader.readexactly(2))[0]
        elif n == 127:
            n = struct.unpack("!Q", await self._reader.readexactly(8))[0]
            if n > MAX_MESSAGE:
                raise ProtocolError("message too big")
        key = await self._reader.readexactly(4)
        return fin, opcode, _unmask(await self._reader.readexactly(n), key)

    async def _read_loop(self) -> None:
        asm = _Assembler(expect_masked=True)
        try:
            while True:
                fin, opcode, payload = await self._read_frame(asm)
                if opcode == OP_PING:
                    await self._write(encode_frame(OP_PONG, payload))
                elif opcode == OP_CLOSE:
                    self._closed = ConnectionClosed(*parse_close(payload))
                    if not self._close_sent:
                        self._close_sent = True
                        await self._write(encode_frame(OP_CLOSE, payload[:2]))
                    break
                elif opcode != OP_PONG:
                    msg = asm.data_frame(fin, opcode, payload)
                    if msg is not None:
                        self._messages.put_nowait(msg)
        except ProtocolError as e:
            self._closed = ConnectionClosed(e.code, str(e))
            await self._send_close(e.code, str(e))
        except (asyncio.IncompleteReadError, ConnectionError, OSError):
            self._closed = ConnectionClosed(1006, "the stream ended without a close frame")
        finally:
            if self._closed is None:
                self._closed = ConnectionClosed(1006, "the connection was dropped")
            self._messages.put_nowait(self._closed)
            self._writer.close()

    async def _send_close(self, code: int, reason: str = "") -> None:
        if self._close_sent:
            return
        self._close_sent = True
        try:
            await self._write(encode_frame(OP_CLOSE, close_payload(code, reason)))
        except (ConnectionError, OSError):
            pass  # the peer is gone already; the connection is closed either way

    async def send(self, text: str) -> None:
        if self._closed is not None:
            raise self._closed
        await self._write(encode_frame(OP_TEXT, text.encode()))

    async def recv(self, timeout: Optional[float] = None) -> str:
        """The next message; ``TimeoutError`` after ``timeout`` seconds,
        ``ConnectionClosed`` once the connection is closed."""
        item = await asyncio.wait_for(self._messages.get(), timeout)
        if isinstance(item, ConnectionClosed):
            self._messages.put_nowait(item)  # every later recv raises too
            raise item
        return item

    async def close(self, code: int = CLOSE_NORMAL, reason: str = "", timeout: float = 5.0) -> None:
        """The close handshake: send a close frame, wait for the peer's."""
        await self._send_close(code, reason)
        try:
            await asyncio.wait_for(asyncio.shield(self._reader_task), timeout)
        except asyncio.TimeoutError:
            self._reader_task.cancel()
            self._writer.close()


async def _handshake(reader: asyncio.StreamReader, writer: asyncio.StreamWriter) -> bool:
    """Read the client's upgrade request and answer it: 101, or 400 and
    False."""
    request = await asyncio.wait_for(reader.readuntil(b"\r\n\r\n"), 10.0)
    lines = request.decode("latin-1").split("\r\n")
    method, _, version = (lines[0].split(" ") + ["", "", ""])[:3]
    headers = {}
    for line in lines[1:]:
        if ":" in line:
            k, v = line.split(":", 1)
            headers[k.strip().lower()] = v.strip()
    key = headers.get("sec-websocket-key", "")
    ok = (method == "GET" and version.startswith("HTTP/1.1")
          and headers.get("upgrade", "").lower() == "websocket"
          and "upgrade" in [t.strip().lower() for t in headers.get("connection", "").split(",")]
          and headers.get("sec-websocket-version") == "13" and len(base64.b64decode(key + "==")) >= 16)
    if not ok:
        writer.write(b"HTTP/1.1 400 Bad Request\r\nContent-Length: 0\r\nConnection: close\r\n\r\n")
        await writer.drain()
        return False
    writer.write(("HTTP/1.1 101 Switching Protocols\r\nUpgrade: websocket\r\nConnection: Upgrade\r\n"
                  f"Sec-WebSocket-Accept: {accept_key(key)}\r\n\r\n").encode())
    await writer.drain()
    return True


class Server:
    """The listening server of ``serve``: ``port`` is the bound port (a
    free one when 0 was asked for)."""

    def __init__(self, handler: Callable, host: str, port: int):
        self._handler, self.host, self.port = handler, host, port
        self._server: Optional[asyncio.base_events.Server] = None
        self._connections: set = set()

    async def _accept(self, reader, writer) -> None:
        try:
            ok = await _handshake(reader, writer)
        except (asyncio.IncompleteReadError, asyncio.LimitOverrunError, asyncio.TimeoutError, ConnectionError,
                ValueError):
            ok = False
        if not ok:
            writer.close()
            return
        conn = ServerConnection(reader, writer)
        self._connections.add(conn)
        try:
            await self._handler(conn)
        finally:
            self._connections.discard(conn)
            await conn.close()

    async def __aenter__(self) -> "Server":
        self._server = await asyncio.start_server(self._accept, self.host, self.port)
        self.port = self._server.sockets[0].getsockname()[1]
        return self

    async def __aexit__(self, *exc) -> None:
        self._server.close()
        for conn in list(self._connections):
            await conn.close(timeout=2.0)
        await self._server.wait_closed()


def serve(handler: Callable, host: str = "127.0.0.1", port: int = 0) -> Server:
    """``async with serve(handler, host, port) as server:`` listens until
    the block ends; a bind failure raises ``OSError`` from the ``async
    with``."""
    return Server(handler, host, port)


# -- blocking client ------------------------------------------------------


class ClientConnection:
    """A blocking client connection (``connect``). Bytes read past a whole
    frame stay buffered, so a ``recv`` that times out loses nothing."""

    def __init__(self, sock: socket.socket, buf: bytes = b""):
        self._sock, self._buf = sock, buf
        self._asm = _Assembler(expect_masked=False)
        self._closed: Optional[ConnectionClosed] = None

    def _frame(self, deadline: Optional[float]) -> Tuple[bool, int, bytes]:
        """The next whole frame, reading the socket until ``deadline``."""
        while True:
            if len(self._buf) >= 2:
                fin, opcode, n = self._asm.check_header(self._buf[0], self._buf[1])
                at = {126: 4, 127: 10}.get(n, 2)
                if len(self._buf) >= at:
                    if at > 2:
                        n = int.from_bytes(self._buf[2:at], "big")
                    if len(self._buf) >= at + n:
                        payload, self._buf = self._buf[at:at + n], self._buf[at + n:]
                        return fin, opcode, payload
            wait = None if deadline is None else max(0.0, deadline - time.monotonic())
            if not select.select([self._sock], [], [], wait)[0]:
                raise TimeoutError("websocket recv timed out")
            data = self._sock.recv(1 << 16)
            if not data:
                raise ConnectionClosed(1006, "the stream ended without a close frame")
            self._buf += data

    def _control(self, opcode: int, payload: bytes) -> None:
        """Answer a ping; on a close frame answer it and raise."""
        if opcode == OP_PING:
            self._sock.sendall(encode_frame(OP_PONG, payload, mask=True))
        elif opcode == OP_CLOSE:
            self._closed = ConnectionClosed(*parse_close(payload))
            try:
                self._sock.sendall(encode_frame(OP_CLOSE, payload[:2], mask=True))
            except OSError:
                pass  # the server may have closed its end already
            self._sock.close()
            raise self._closed

    def recv(self, timeout: Optional[float] = None) -> str:
        """The next message; ``TimeoutError`` after ``timeout`` seconds,
        ``ConnectionClosed`` once the server closed."""
        if self._closed is not None:
            raise self._closed
        deadline = None if timeout is None else time.monotonic() + timeout
        try:
            while True:
                fin, opcode, payload = self._frame(deadline)
                if opcode >= 0x8:
                    self._control(opcode, payload)
                else:
                    msg = self._asm.data_frame(fin, opcode, payload)
                    if msg is not None:
                        return msg
        except ProtocolError as e:
            self.close(e.code, str(e))
            raise ConnectionClosed(e.code, str(e)) from None

    def send(self, text: str) -> None:
        if self._closed is not None:
            raise self._closed
        self._sock.sendall(encode_frame(OP_TEXT, text.encode(), mask=True))

    def ping(self, data: bytes = b"ping", timeout: float = 10.0) -> None:
        """Send a ping and wait for its pong. Call it with no message in
        flight: a data message that arrives first raises ``ProtocolError``."""
        self._sock.sendall(encode_frame(OP_PING, data, mask=True))
        deadline = time.monotonic() + timeout
        while True:
            _, opcode, payload = self._frame(deadline)
            if opcode == OP_PONG and payload == data:
                return
            if opcode < 0x8:
                raise ProtocolError("a data message arrived before the pong")
            self._control(opcode, payload)

    def close(self, code: int = CLOSE_NORMAL, reason: str = "", timeout: float = 5.0) -> None:
        """The close handshake: send a close frame, read until the server's
        (data messages still in flight are dropped), close the socket."""
        if self._closed is not None:
            return
        try:
            self._sock.sendall(encode_frame(OP_CLOSE, close_payload(code, reason), mask=True))
            deadline = time.monotonic() + timeout
            while True:
                _, opcode, payload = self._frame(deadline)
                if opcode == OP_CLOSE:
                    self._closed = ConnectionClosed(*parse_close(payload))
                    break
        except (ConnectionClosed, TimeoutError, OSError, ProtocolError):
            self._closed = self._closed or ConnectionClosed(code, reason)
        finally:
            self._sock.close()

    def __enter__(self) -> "ClientConnection":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def connect(uri: str, timeout: float = 10.0) -> ClientConnection:
    """Open ``ws://host:port/path`` and complete the opening handshake."""
    u = urlparse(uri)
    if u.scheme != "ws":
        raise ValueError(f"only ws:// URIs are supported, not {uri!r}")
    host, port = u.hostname, u.port or 80
    sock = socket.create_connection((host, port), timeout=timeout)
    key = base64.b64encode(os.urandom(16)).decode()
    path = (u.path or "/") + (f"?{u.query}" if u.query else "")
    sock.sendall((f"GET {path} HTTP/1.1\r\nHost: {host}:{port}\r\nUpgrade: websocket\r\nConnection: Upgrade\r\n"
                  f"Sec-WebSocket-Key: {key}\r\nSec-WebSocket-Version: 13\r\n\r\n").encode())
    buf = b""
    while b"\r\n\r\n" not in buf:
        data = sock.recv(4096)
        if not data:
            sock.close()
            raise ConnectionError(f"{uri}: the server closed during the handshake")
        buf += data
    head, rest = buf.split(b"\r\n\r\n", 1)
    lines = head.decode("latin-1").split("\r\n")
    headers = {k.strip().lower(): v.strip() for k, v in (ln.split(":", 1) for ln in lines[1:] if ":" in ln)}
    if lines[0].split(" ")[1:2] != ["101"] or headers.get("sec-websocket-accept") != accept_key(key):
        sock.close()
        raise ConnectionError(f"{uri}: handshake refused: {lines[0]!r}")
    sock.settimeout(None)
    return ClientConnection(sock, rest)

"""TCP active messages: the parcel layer of the multi-locality runtime.

Counterpart: ``repro/distrib/messaging.py``, copied: the module imports
no JAX, and its frames, envelopes and payload pickles are the
reference's, and so are the runtime sanitizer's hooks: a post to an
unregistered action (PHY102) and an ack dropped because its requester is
gone (PHY104).  Five changes, none on the wire:
``close`` shuts its connections down before closing them, so that a peer
sees an endpoint closed in a live process end as it sees a dead
process's; a frame is read into one buffer of its size and sent as its
length prefix and its body without joining them, so that the gradient
ring's frames of a gigabyte or more cost no extra copies; a peer lost
while the endpoint closes no longer raises in its reader thread (the
handler pool is already shut down: nobody is left to tell); and a dialed
connection drops the dial's timeout once it is connected.  The reference
keeps the 30 s timeout on the socket, so a connection quiet for 30 s
(a worker waiting out a long step between two gradient ring frames)
ends its reader and fires peer-lost at the dialing end, which then
closes: its peer's next send fails with a broken pipe.

HPX moves work between localities with *parcels* - messages that carry an
action (what to run) plus its arguments, and invoke that action at the
receiver.  This module is the socket-level analogue (DESIGN.md §9):

  * **Frames.**  Length-prefixed: a 4-byte big-endian length, then a
    msgpack-encoded envelope ``{kind, action, seq, src, ok, payload}``
    where ``payload`` is a pickled Python value (msgpack handles the
    fixed envelope cheaply; pickle handles arbitrary arguments - numpy
    arrays, dataclasses, top-level functions).  When msgpack is absent
    the whole envelope is pickled; both ends must agree, which they do
    because every process runs this same module.
  * **Request/ack.**  ``request()`` sends a ``req`` frame and blocks for
    the matching ``ack`` (by ``seq``); the handler's return value rides
    back in the ack, its exception rides back pickled and re-raises at
    the caller.  ``post()`` is fire-and-forget - the active-message
    spawn path, where completion comes back later as its own post.
  * **Peers.**  Every endpoint listens; connections are dialed on demand
    and identified by an ``__ident__`` post carrying the dialer's rank
    and listen address, so either side can initiate.  A dead peer fails
    its pending requests with ``PeerLostError`` and fires
    ``on_peer_lost(rank)`` exactly once - the hook the distributed
    scheduler uses to re-spawn a lost locality's tasks.

Handlers run on a small thread pool, never on the reader thread, so a
slow handler cannot stall frame delivery (or heartbeats) from the same
peer.
"""
from __future__ import annotations

import collections
import logging
import pickle
import socket
import struct
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Optional

from ..analysis import sanitize as _san

try:
    import msgpack
except ImportError:                  # pragma: no cover - container has it
    msgpack = None

log = logging.getLogger("repro_torch.distrib")

__all__ = ["Endpoint", "PeerLostError", "raw_request", "recv_frame",
           "send_frame"]

_LEN = struct.Struct("!I")           # frame length prefix; frames < 4 GiB
DIAL_TIMEOUT_S = 30.0                # a dial's connect, not its connection


class PeerLostError(ConnectionError):
    """The connection to a locality died with requests still pending."""


def _pack(env: dict) -> bytes:
    if msgpack is not None:
        return msgpack.packb(env, use_bin_type=True)
    return pickle.dumps(env, protocol=pickle.HIGHEST_PROTOCOL)


def _unpack(body: bytes) -> dict:
    if msgpack is not None:
        return msgpack.unpackb(body, raw=False)
    return pickle.loads(body)


def send_frame(sock: socket.socket, env: dict):
    """Serialize ``env`` and write one length-prefixed frame.

    Args:
        sock: a connected stream socket.
        env: the envelope dict (``payload`` must already be bytes).
    Raises:
        OSError: the peer is gone; the caller maps this to peer loss.
    """
    body = _pack(env)
    sock.sendall(_LEN.pack(len(body)) + body)


def _recv_exact(sock: socket.socket, n: int) -> bytearray:
    # into one buffer of the frame's size: a recv(n) of a large frame
    # would allocate n bytes on every call however little it returns
    buf = bytearray(n)
    view = memoryview(buf)
    got = 0
    while got < n:
        k = sock.recv_into(view[got:], n - got)
        if not k:
            raise ConnectionError("peer closed the connection")
        got += k
    return buf


def recv_frame(sock: socket.socket) -> dict:
    """Read one length-prefixed frame and return the decoded envelope.

    Raises:
        ConnectionError: the peer closed mid-frame or before one.
    """
    (n,) = _LEN.unpack(_recv_exact(sock, _LEN.size))
    return _unpack(_recv_exact(sock, n))


def dumps(obj: Any) -> bytes:
    """Payload serializer (pickle, highest protocol) - one definition so
    the wire format is specified in exactly one module."""
    return pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL)


def loads(data: bytes) -> Any:
    """Inverse of ``dumps``."""
    return pickle.loads(data)


def raw_request(address: tuple[str, int], action: str, payload: Any = None,
                *, timeout: float = 60.0) -> Any:
    """One-shot request over a fresh socket, no ``Endpoint`` required.

    The dial-in join handshake (DESIGN.md §13) runs before the joiner has
    a rank, so it cannot own an endpoint yet; it sends a single ``req``
    with ``src=-1`` and the receiver acks back over this same socket
    (see ``_dispatch``'s anonymous-requester fallback).

    Args:
        address: the listening ``(host, port)`` of a live endpoint.
        action: registered handler name there.
        payload: any picklable value.
        timeout: seconds for connect and for the ack.
    Returns:
        The remote handler's return value.
    Raises:
        Exception: whatever the remote handler raised, re-raised here.
        ConnectionError / TimeoutError: transport failure.
    """
    sock = socket.create_connection(tuple(address), timeout=timeout)
    try:
        sock.settimeout(timeout)
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        send_frame(sock, {"kind": "req", "action": action, "seq": 1,
                          "src": -1, "payload": dumps(payload)})
        env = recv_frame(sock)
        value = loads(env["payload"])
        if not env.get("ok", True):
            raise value
        return value
    finally:
        try:
            sock.close()
        except OSError:
            pass


class _Pending:
    __slots__ = ("event", "raw", "ok", "exc", "rank")

    def __init__(self, rank: int):
        self.event = threading.Event()
        self.raw: Optional[bytes] = None  # undecoded ack payload
        self.ok = True
        self.exc: Optional[BaseException] = None   # transport-level error
        self.rank = rank                 # destination, for targeted failure


class Endpoint:
    """One locality's active-message endpoint: a listener, a connection
    cache keyed by peer rank, and an action registry.

    Args:
        rank: this locality's rank (0 is the driver).
        host: interface to bind; loopback by default (single-node CI).
        port: listen port; 0 (the default) picks an ephemeral one.  A
            fixed port lets elastic joiners dial a known driver address
            (``--elastic-port`` / ``--join``).
        handler_threads: size of the pool handlers run on.

    Handlers are registered per action name via ``register`` and called
    as ``handler(src_rank, payload)``; for ``req`` frames the return
    value is shipped back in the ack.  ``bytes_sent`` / ``bytes_recv``
    count serialized frame bytes - the benchmark's wire-cost counters.
    """

    def __init__(self, rank: int, host: str = "127.0.0.1", *, port: int = 0,
                 handler_threads: int = 4):
        self.rank = rank
        self._handlers: dict[str, Callable[[int, Any], Any]] = {}
        self._conns: dict[int, socket.socket] = {}
        self._send_locks: dict[int, threading.Lock] = {}
        self._pending: dict[int, _Pending] = {}
        self._lost: set[int] = set()
        self._lock = threading.RLock()
        # (host, port) addresses with a dial in flight: a second dialer
        # to the same address waits on the condition instead of opening
        # a duplicate socket
        self._dialing: set[tuple[str, int]] = set()
        self._dial_cond = threading.Condition(self._lock)
        self._seq = 0
        self._closed = False
        self.on_peer_lost: Optional[Callable[[int], None]] = None
        # rank -> (host, port): lets _send dial lazily (worker-to-worker
        # AGAS fetches) instead of requiring pre-built connections
        self.address_book: dict[int, tuple[str, int]] = {}
        self.bytes_sent = 0
        self.bytes_recv = 0
        # posts to unregistered actions: a req gets its error acked back,
        # but a post has nobody to tell - so every drop is counted here
        # (surfaced through runtime stats) and warned once per action
        self.unhandled_posts: collections.Counter = collections.Counter()
        self._warned_unhandled: set[str] = set()
        self._pool = ThreadPoolExecutor(
            max_workers=handler_threads,
            thread_name_prefix=f"am{rank}-handler")
        self._listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._listener.bind((host, port))
        self._listener.listen(32)
        self.address: tuple[str, int] = self._listener.getsockname()
        self._accept_thread = threading.Thread(
            target=self._accept_loop, daemon=True, name=f"am{rank}-accept")
        self._accept_thread.start()
        self.register("__ident__", lambda src, p: None)

    # -- registry -----------------------------------------------------------
    def register(self, action: str, handler: Callable[[int, Any], Any]):
        """Bind ``handler(src_rank, payload)`` to ``action`` frames."""
        self._handlers[action] = handler

    # -- connections --------------------------------------------------------
    def connect(self, rank: int, address: tuple[str, int]):
        """Ensure a live connection to ``rank`` at ``address`` (no-op if
        one exists); identifies this endpoint to the peer.

        Idempotent under concurrency: dials to the same (host, port)
        collapse to one socket - a second local dialer waits for the
        first, and a dial that loses to a simultaneous inbound
        connection from the same peer (both sides of a join dialing
        each other) closes its duplicate instead of adopting it.
        """
        address = (address[0], int(address[1]))
        with self._dial_cond:
            if rank in self._conns or self._closed:
                return
            while address in self._dialing:
                self._dial_cond.wait(timeout=35)
                if rank in self._conns or self._closed:
                    return
            self._dialing.add(address)
        # dial OUTSIDE the endpoint lock: a slow handshake must not
        # stall unrelated sends / acks / reader registration
        try:
            sock = socket.create_connection(address, timeout=DIAL_TIMEOUT_S)
            # the timeout bounds the connect alone: left on the socket, it
            # would end the reader of a connection quiet for that long
            sock.settimeout(None)
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        except OSError:
            with self._dial_cond:
                self._dialing.discard(address)
                self._dial_cond.notify_all()
            raise
        with self._dial_cond:
            self._dialing.discard(address)
            self._dial_cond.notify_all()
            adopt = not self._closed and rank not in self._conns
            if adopt:
                self._adopt(rank, sock)
        if not adopt:
            # lost the race (inbound connection from the peer, or the
            # endpoint closed): discard the duplicate quietly
            try:
                sock.close()
            except OSError:
                pass
            return
        self._send(rank, {"kind": "post", "action": "__ident__", "seq": 0,
                          "src": self.rank,
                          "payload": dumps({"rank": self.rank,
                                            "addr": list(self.address)})})

    def _adopt(self, rank: int, sock: socket.socket):
        self._conns[rank] = sock
        self._send_locks[rank] = threading.Lock()
        self._lost.discard(rank)
        threading.Thread(target=self._read_loop, args=(rank, sock),
                         daemon=True,
                         name=f"am{self.rank}-read-{rank}").start()

    def peers(self) -> list[int]:
        """Ranks with a live connection right now."""
        with self._lock:
            return sorted(self._conns)

    # -- messaging ----------------------------------------------------------
    def post(self, rank: int, action: str, payload: Any = None):
        """Fire-and-forget active message: run ``action`` at ``rank``.

        Raises:
            PeerLostError: no live connection to ``rank``.
        """
        self._send(rank, {"kind": "post", "action": action, "seq": 0,
                          "src": self.rank, "payload": dumps(payload)})

    def request(self, rank: int, action: str, payload: Any = None, *,
                timeout: float = 60.0) -> Any:
        """Run ``action`` at ``rank`` and block for its reply.

        Args:
            rank: destination locality.
            action: registered handler name at the destination.
            payload: any picklable value.
            timeout: seconds to wait for the ack.
        Returns:
            The remote handler's return value.
        Raises:
            PeerLostError: the peer died before acking.
            TimeoutError: no ack within ``timeout``.
            Exception: whatever the remote handler raised, re-raised here.
        """
        with self._lock:
            self._seq += 1
            seq = self._seq
            pend = self._pending[seq] = _Pending(rank)
        try:
            self._send(rank, {"kind": "req", "action": action, "seq": seq,
                              "src": self.rank, "payload": dumps(payload)})
            if not pend.event.wait(timeout):
                raise TimeoutError(
                    f"no ack for {action!r} from locality {rank} "
                    f"within {timeout}s")
        finally:
            with self._lock:
                self._pending.pop(seq, None)
        if pend.exc is not None:
            raise pend.exc
        # decode on the caller's thread (never the reader's): an
        # undecodable ack is this request's problem, not the peer's
        try:
            value = loads(pend.raw)
        except Exception as e:  # noqa: BLE001 - surfaced to the caller
            raise RuntimeError(
                f"undecodable ack payload for {action!r} from locality "
                f"{rank}: {e}") from e
        if not pend.ok:
            raise value
        return value

    def _send(self, rank: int, env: dict):
        body = _pack(env)
        for attempt in (0, 1):
            with self._lock:
                sock = self._conns.get(rank)
                lock = self._send_locks.get(rank)
            if sock is None and rank in self.address_book:
                try:
                    self.connect(rank, self.address_book[rank])
                except OSError as e:
                    raise PeerLostError(
                        f"cannot reach locality {rank}: {e}") from e
                with self._lock:
                    sock = self._conns.get(rank)
                    lock = self._send_locks.get(rank)
            if sock is None or lock is None:
                raise PeerLostError(f"no connection to locality {rank}")
            try:
                with lock:      # the prefix, then the body: no joined copy
                    sock.sendall(_LEN.pack(len(body)))
                    sock.sendall(body)
            except OSError as e:
                self._drop(rank, sock)
                with self._lock:
                    swapped = self._conns.get(rank) is not None
                if swapped and attempt == 0:
                    # the connection was canonicalized to a different
                    # socket mid-send (concurrent-dial dedupe): retry
                    # once on the surviving one
                    continue
                raise PeerLostError(
                    f"send to locality {rank} failed: {e}") from e
            with self._lock:
                self.bytes_sent += len(body)
            return

    # -- internals ----------------------------------------------------------
    def _accept_loop(self):
        while True:
            try:
                sock, _ = self._listener.accept()
            except OSError:
                return                      # listener closed
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            # peer is anonymous until its __ident__ arrives
            threading.Thread(target=self._read_loop, args=(None, sock),
                             daemon=True,
                             name=f"am{self.rank}-read-anon").start()

    def _read_loop(self, rank: Optional[int], sock: socket.socket):
        try:
            while True:
                (n,) = _LEN.unpack(_recv_exact(sock, _LEN.size))
                env = _unpack(_recv_exact(sock, n))
                with self._lock:
                    self.bytes_recv += n
                if env["action"] == "__ident__":
                    ident = loads(env["payload"])
                    rank = ident["rank"]
                    self.address_book.setdefault(rank,
                                                 tuple(ident["addr"]))
                    loser = None
                    with self._lock:
                        cur = self._conns.get(rank)
                        if cur is None:
                            self._adopt_identified(rank, sock)
                        elif cur is not sock and rank < self.rank:
                            # concurrent bidirectional dial: both sides
                            # converge on the socket dialed by the LOWER
                            # rank (this inbound one here; the peer keeps
                            # its own dial and drops ours when our ident
                            # reaches it) - deterministic, so exactly one
                            # logical connection survives
                            loser = cur
                            self._adopt_identified(rank, sock)
                    if loser is not None:
                        try:
                            loser.close()
                        except OSError:
                            pass
                    continue
                self._dispatch(rank if rank is not None else env.get("src"),
                               sock, env)
        except (ConnectionError, OSError):
            pass
        finally:
            if rank is not None:
                self._drop(rank, sock)

    def _adopt_identified(self, rank: int, sock: socket.socket):
        # adopted from accept: register without spawning another reader
        self._conns[rank] = sock
        self._send_locks[rank] = threading.Lock()
        self._lost.discard(rank)

    def _dispatch(self, src: Optional[int], sock: socket.socket, env: dict):
        kind = env["kind"]
        if kind == "ack":
            with self._lock:
                pend = self._pending.get(env["seq"])
            if pend is not None:
                pend.raw = env["payload"]
                pend.ok = env.get("ok", True)
                pend.event.set()
            return
        handler = self._handlers.get(env["action"])

        def run():
            # decode on the pool, never the reader thread: a large or
            # undecodable payload must not stall (or kill) the connection
            try:
                payload = loads(env["payload"])
            except Exception as e:  # noqa: BLE001 - shipped back as error
                payload, decode_err = None, RuntimeError(
                    f"locality {self.rank}: undecodable payload for "
                    f"{env['action']!r}: {e}")
            else:
                decode_err = None
            if decode_err is not None:
                ok, value = False, decode_err
            elif handler is None:
                err: Any = RuntimeError(
                    f"locality {self.rank}: no handler for "
                    f"{env['action']!r}")
                ok, value = False, err
                if kind == "post":   # a req acks the error back; a post
                    self._note_unhandled(env["action"], src)  # cannot
            else:
                try:
                    ok, value = True, handler(src, payload)
                except BaseException as e:  # noqa: BLE001 - shipped back
                    ok, value = False, e
            if kind == "req" and src is not None:
                try:
                    ack = {"kind": "ack", "seq": env["seq"],
                           "src": self.rank, "action": "",
                           "ok": ok, "payload": dumps(value)}
                    try:
                        self._send(src, ack)
                    except PeerLostError:
                        # an unregistered requester - the dial-in join
                        # handshake posts from src=-1 before it has an
                        # endpoint - gets its ack back over the socket
                        # the request arrived on
                        send_frame(sock, ack)
                        with self._lock:
                            self.bytes_sent += len(ack["payload"])
                except (OSError, pickle.PicklingError, TypeError) as e:
                    # requester is gone or the value is unpicklable; the
                    # reply is undeliverable either way (PHY104)
                    if _san.active():
                        _san.get().record(
                            "PHY104",
                            f"locality {self.rank}: ack for "
                            f"{env['action']!r} to locality {src} "
                            f"dropped: {e}",
                            once_key=f"{self.rank}:{src}:{env['action']}")

        if self._closed:
            return
        self._pool.submit(run)

    def _note_unhandled(self, action: str, src: Optional[int]):
        with self._lock:
            self.unhandled_posts[action] += 1
            first = action not in self._warned_unhandled
            if first:
                self._warned_unhandled.add(action)
        if first:
            log.warning(
                "locality %d: dropped post to unregistered action %r "
                "(from locality %s); further drops to it are counted "
                "in unhandled_posts without logging", self.rank, action,
                src)
        if _san.active():
            _san.get().record(
                "PHY102",
                f"locality {self.rank}: post to unregistered action "
                f"{action!r} (from locality {src})",
                once_key=f"{self.rank}:{action}")

    def _drop(self, rank: int, sock: Optional[socket.socket] = None):
        """Tear down the connection to ``rank``.

        With ``sock`` given, acts only if it IS the registered
        connection: a deduped duplicate socket dying (the loser of a
        concurrent bidirectional dial) must not take the live connection
        - or fire a spurious peer-lost - with it.
        """
        cb = None
        with self._lock:
            cur = self._conns.get(rank)
            if sock is not None and cur is not None and cur is not sock:
                dead = sock            # a duplicate died, not the conn
                fire = False
                pend: list[_Pending] = []
            else:
                self._conns.pop(rank, None)
                self._send_locks.pop(rank, None)
                dead = cur if cur is not None else sock
                fire = (cur is not None and rank not in self._lost
                        and not self._closed)
                if fire:
                    self._lost.add(rank)
                    cb = self.on_peer_lost
                pend = [p for p in self._pending.values()
                        if p.rank == rank]
        if dead is not None:
            try:
                dead.close()
            except OSError:
                pass
        if fire:
            for p in pend:      # fail requests that may be waiting on it
                if not p.event.is_set():
                    p.exc = PeerLostError(f"locality {rank} disconnected")
                    p.event.set()
            if cb is not None:
                try:
                    self._pool.submit(cb, rank)
                except RuntimeError:
                    pass        # closed since the check: nobody to tell

    def close(self):
        """Stop accepting, close every connection, drain the handler pool.
        Idempotent; pending requests fail with ``PeerLostError``."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
            conns = list(self._conns.items())
            self._conns.clear()
            self._send_locks.clear()
        try:
            self._listener.close()
        except OSError:
            pass
        for _, sock in conns:
            try:
                # shutdown first: a close alone leaves the connection up
                # while this endpoint's reader thread still blocks in recv
                # on it, so the peer would never see it end
                sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                sock.close()
            except OSError:
                pass
        with self._lock:
            for p in self._pending.values():
                if not p.event.is_set():
                    p.exc = PeerLostError("endpoint closed")
                    p.event.set()
        self._pool.shutdown(wait=False)

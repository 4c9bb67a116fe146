"""Point-to-point activation and gradient transfer for MPMD stage groups
(the port of ``tpudml/comm/p2p.py``).

An MPMD pipeline is many process groups, one a stage (``tpudml_torch.mpmd``),
and no collective spans two of them. The tensors that cross a stage
boundary travel outside any group, over plain TCP between the boundary
ranks, with a framing contract strict enough that a resumed incarnation
replays the same byte stream:

- **deterministic (step, microbatch, edge) framing**: every frame carries
  the training step, the wire chunk (microbatch) index, a direction tag
  (``act`` forward, ``grad`` backward, ``ctl`` for the drain barrier) and
  the edge label (``s0r1->s1r0``). The receiver states what it expects;
  any mismatch is a :class:`FramingError` (a protocol bug), never
  silently reordered data.
- **integrity**: a CRC-32 of the payload in every frame, checked on
  receipt.
- **peer death is a membership event**: EOF, connection reset and a
  receive timeout all raise :class:`PeerDeadError`, which the stage loop
  catches to drain (``mpmd/runtime.py``).

The frames are JAX's byte for byte: the same magic, the same header JSON
(``sort_keys``, compact separators, numpy's dtype names) and the same
payload bytes, so a JAX rank and a port rank can share one socket. The
port's channel carries **CPU torch tensors**: a stage on the card moves
its boundary tensors to the host before it sends them. A ``bfloat16``
payload is decoded with ``torch.frombuffer`` and a view, so nothing here
needs ``ml_dtypes``.

An MPMD edge ships its payload once, so it is priced as the ``"p2p"``
kind of the shared ring wire model (:func:`p2p_wire_bytes`). Every frame
lands on the ambient flight recorder as a ``cat="comm"`` complete span
with the edge and the byte count, as ``CommStats`` records collectives.
"""

from __future__ import annotations

import json
import socket
import struct
import time
import zlib

import torch

from tpudml_torch.comm.timing import collective_wire_bytes

FRAME_MAGIC = 0x4D504D44  # "MPMD"
FRAME_VERSION = 1

TAG_ACT = "act"
TAG_GRAD = "grad"
TAG_CTL = "ctl"
_TAGS = (TAG_ACT, TAG_GRAD, TAG_CTL)

#: Barrier verdicts (1-byte ctl payloads).
VOTE_OK = b"\x01"
VOTE_DRAIN = b"\x00"

#: torch dtype <-> numpy's dtype name, the name a frame's header carries.
_DTYPE_NAMES = {
    torch.float64: "float64",
    torch.float32: "float32",
    torch.float16: "float16",
    torch.bfloat16: "bfloat16",
    torch.int64: "int64",
    torch.int32: "int32",
    torch.int16: "int16",
    torch.int8: "int8",
    torch.uint8: "uint8",
    torch.bool: "bool",
}
_DTYPES = {name: dt for dt, name in _DTYPE_NAMES.items()}


class FramingError(RuntimeError):
    """The peer sent a frame the receiver did not expect: a protocol bug
    (schedule divergence), distinct from peer death."""


class PeerDeadError(RuntimeError):
    """EOF, reset or timeout on a p2p channel: the peer (or its whole stage
    group) is gone. Carries the last successfully framed (step,
    microbatch) so the drain report can say what was in flight."""

    def __init__(self, msg: str, *, edge: str = "?", step: int = -1,
                 microbatch: int = -1):
        super().__init__(msg)
        self.edge = edge
        self.step = step
        self.microbatch = microbatch


def p2p_wire_bytes(payload_bytes: int) -> float:
    """Ring-model bytes for one MPMD edge transfer: the ``"p2p"`` kind
    ships the payload once (``comm/timing._WIRE_MODEL``)."""
    return collective_wire_bytes("p2p", payload_bytes, 2)


def _dtype_name(dtype: torch.dtype) -> str:
    """numpy's name of ``dtype`` (the frame header's ``dtype``)."""
    try:
        return _DTYPE_NAMES[dtype]
    except KeyError:
        raise ValueError(f"no wire encoding for {dtype}") from None


def resolve_dtype(name: str) -> torch.dtype:
    """The torch dtype of a frame header's numpy dtype name."""
    try:
        return _DTYPES[name]
    except KeyError:
        raise FramingError(f"frame dtype {name!r} has no torch counterpart") from None


def _recv_exact(sock: socket.socket, n: int, *, edge: str) -> bytearray:
    buf = bytearray(n)
    view = memoryview(buf)
    got = 0
    while got < n:
        try:
            k = sock.recv_into(view[got:], n - got)
        except (socket.timeout, TimeoutError) as e:
            raise PeerDeadError(f"p2p recv timeout on edge {edge}", edge=edge) from e
        except (ConnectionResetError, BrokenPipeError, OSError) as e:
            raise PeerDeadError(f"p2p connection lost on edge {edge}: {e!r}",
                                edge=edge) from e
        if k == 0:
            raise PeerDeadError(f"p2p EOF on edge {edge}", edge=edge)
        got += k
    return buf


_HDR = struct.Struct("!II")  # magic, header_len


def _payload(t: torch.Tensor) -> bytes:
    """The tensor's bytes in C order (the bytes numpy's ``tobytes`` gives)."""
    if t.device.type != "cpu":
        raise ValueError(f"the p2p wire carries host tensors; got one on {t.device} "
                         "(move it to the CPU first)")
    return t.detach().contiguous().reshape(-1).view(torch.uint8).numpy().tobytes()


def _decode(payload: bytearray, name: str, shape) -> torch.Tensor:
    dtype = resolve_dtype(name)
    if not payload:
        return torch.empty(tuple(shape), dtype=dtype)
    return torch.frombuffer(payload, dtype=torch.uint8).view(dtype).reshape(tuple(shape))


def send_frame(sock: socket.socket, arr: torch.Tensor, *, step: int, microbatch: int,
               tag: str, edge: str) -> int:
    """Send one framed tensor; returns the payload bytes on the wire."""
    if tag not in _TAGS:
        raise ValueError(f"unknown frame tag {tag!r}")
    payload = _payload(arr)
    header = json.dumps(
        {
            "v": FRAME_VERSION,
            "step": int(step),
            "microbatch": int(microbatch),
            "tag": tag,
            "edge": edge,
            "dtype": _dtype_name(arr.dtype),
            "shape": [int(n) for n in arr.shape],
            "nbytes": len(payload),
            "crc": zlib.crc32(payload),
        },
        sort_keys=True,
        separators=(",", ":"),
    ).encode()
    try:
        sock.sendall(_HDR.pack(FRAME_MAGIC, len(header)) + header + payload)
    except (ConnectionResetError, BrokenPipeError, OSError) as e:
        raise PeerDeadError(f"p2p send failed on edge {edge}: {e!r}",
                            edge=edge, step=step, microbatch=microbatch) from e
    return len(payload)


def recv_frame(sock: socket.socket, *, step: int, microbatch: int, tag: str,
               edge: str) -> torch.Tensor:
    """Receive one frame, enforcing the deterministic framing: the frame on
    the wire must carry exactly the (step, microbatch, tag, edge) the
    caller expects. Returns a CPU tensor."""
    magic, hlen = _HDR.unpack(_recv_exact(sock, _HDR.size, edge=edge))
    if magic != FRAME_MAGIC:
        raise FramingError(f"edge {edge}: bad magic {magic:#x} (expected {FRAME_MAGIC:#x})")
    hdr = json.loads(_recv_exact(sock, hlen, edge=edge))
    # Consume the payload before any mismatch check so the byte stream
    # stays frame-aligned even when the error is caught.
    payload = _recv_exact(sock, int(hdr["nbytes"]), edge=edge)
    got = (hdr.get("step"), hdr.get("microbatch"), hdr.get("tag"), hdr.get("edge"))
    want = (int(step), int(microbatch), tag, edge)
    if got != want:
        raise FramingError(f"frame mismatch on edge {edge}: got (step, microbatch, tag, "
                           f"edge)={got}, expected {want}")
    if zlib.crc32(payload) != hdr["crc"]:
        raise FramingError(f"edge {edge}: payload CRC mismatch at step {step} "
                           f"microbatch {microbatch}")
    return _decode(payload, hdr["dtype"], hdr["shape"])


def _u8(data: bytes) -> torch.Tensor:
    return torch.frombuffer(bytearray(data), dtype=torch.uint8)


class Channel:
    """One full-duplex p2p connection between two boundary ranks.

    Forward activations and backward gradients of one rank pair share the
    socket (the 1F1B schedule's strict alternation keeps the turn order
    unambiguous). Every frame lands on the tracer (``tracer``, else the
    ambient one) as a ``cat="comm"`` complete span with the edge and its
    byte counts."""

    def __init__(self, sock: socket.socket, edge: str, *, tracer=None,
                 timeout_s: float | None = 60.0):
        self.sock = sock
        self.edge = edge
        self.tracer = tracer
        self.bytes_sent = 0
        self.bytes_received = 0
        self.frames = 0
        if timeout_s is not None:
            sock.settimeout(timeout_s)

    def _span(self, name: str, t0: float, nbytes: int, step: int, microbatch: int) -> None:
        tracer = self.tracer
        if tracer is None:
            from tpudml_torch.obs.tracer import get_tracer

            tracer = get_tracer()
        if not tracer.enabled:
            return
        dur_us = int((time.perf_counter() - t0) * 1e6)
        tracer.add_complete(
            name, cat="comm", ts_us=max(0, tracer.now_us() - dur_us), dur_us=dur_us,
            args={"edge": self.edge, "bytes": int(nbytes),
                  "wire_bytes": p2p_wire_bytes(nbytes),
                  "step": int(step), "microbatch": int(microbatch)},
        )

    def send(self, arr: torch.Tensor, *, step: int, microbatch: int, tag: str) -> int:
        t0 = time.perf_counter()
        n = send_frame(self.sock, arr, step=step, microbatch=microbatch, tag=tag,
                       edge=self.edge)
        self.bytes_sent += n
        self.frames += 1
        self._span(f"p2p_send:{tag}", t0, n, step, microbatch)
        return n

    def recv(self, *, step: int, microbatch: int, tag: str) -> torch.Tensor:
        t0 = time.perf_counter()
        arr = recv_frame(self.sock, step=step, microbatch=microbatch, tag=tag,
                         edge=self.edge)
        nbytes = arr.numel() * arr.element_size()
        self.bytes_received += nbytes
        self.frames += 1
        self._span(f"p2p_recv:{tag}", t0, nbytes, step, microbatch)
        return arr

    def close(self) -> None:
        try:
            self.sock.close()
        except OSError:
            pass


def channel_pair(edge: str, **kw) -> tuple[Channel, Channel]:
    """An in-process full-duplex channel pair (``socket.socketpair``): the
    real wire path without a listener, what the in-process pipeline runs
    over."""
    a, b = socket.socketpair()
    return Channel(a, edge, **kw), Channel(b, edge, **kw)


def connect_channel(host: str, port: int, *, edge: str, hello: dict,
                    deadline_s: float = 30.0, tracer=None,
                    timeout_s: float | None = 60.0) -> Channel:
    """Dial a boundary listener, retrying until ``deadline_s`` (stage groups
    start in parallel; the listener may not be up yet), then introduce
    ourselves with a ctl hello frame carrying ``hello``."""
    deadline = time.monotonic() + deadline_s
    last: Exception | None = None
    while time.monotonic() < deadline:
        try:
            sock = socket.create_connection((host, port), timeout=5.0)
            break
        except OSError as e:
            last = e
            time.sleep(0.05)
    else:
        raise PeerDeadError(f"could not connect edge {edge} to {host}:{port} within "
                            f"{deadline_s:.0f}s: {last!r}", edge=edge)
    sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
    ch = Channel(sock, edge, tracer=tracer, timeout_s=timeout_s)
    send_frame(sock, _u8(json.dumps(hello, sort_keys=True).encode()), step=0,
               microbatch=0, tag=TAG_CTL, edge=edge)
    return ch


def accept_channels(listener: socket.socket, n: int, *, deadline_s: float = 30.0,
                    tracer=None,
                    timeout_s: float | None = 60.0) -> dict[str, tuple[Channel, dict]]:
    """Accept ``n`` dialers on an already-bound listener; returns ``edge ->
    (channel, hello)`` keyed by each hello frame's edge."""
    listener.settimeout(deadline_s)
    out: dict[str, tuple[Channel, dict]] = {}
    for _ in range(n):
        try:
            sock, _addr = listener.accept()
        except (socket.timeout, TimeoutError) as e:
            raise PeerDeadError(f"listener timed out waiting for {n} peers "
                                f"(got {len(out)})") from e
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        sock.settimeout(deadline_s)
        # The hello's edge is unknown until read: accept any edge label.
        magic, hlen = _HDR.unpack(_recv_exact(sock, _HDR.size, edge="hello"))
        if magic != FRAME_MAGIC:
            raise FramingError(f"hello: bad magic {magic:#x}")
        hdr = json.loads(_recv_exact(sock, hlen, edge="hello"))
        if hdr.get("tag") != TAG_CTL:
            raise FramingError(f"hello must be a ctl frame, got {hdr!r}")
        payload = _recv_exact(sock, int(hdr["nbytes"]), edge="hello")
        if zlib.crc32(payload) != hdr["crc"]:
            raise FramingError("hello payload CRC mismatch")
        hello = json.loads(bytes(payload))
        edge = hdr["edge"]
        out[edge] = (Channel(sock, edge, tracer=tracer, timeout_s=timeout_s), hello)
    return out


class DrainBarrier:
    """Step-boundary consensus inside one stage group, over ctl frames.

    The step-end gradient sum is a collective: a rank that enters it while
    a peer has already drained (its boundary socket died first) hangs
    until the job's timeout. So before every collective the group votes
    over a star (the stage-local rank 0 is the hub): each leaf sends
    ``ok`` or ``drain``, the hub broadcasts the AND. A rank enters the sum
    only after a unanimous ``ok``, and a rank that voted ok is committed
    to enter it, so the collective never half-starts. Peer death during
    the vote counts as ``drain``.
    """

    def __init__(self, *, hub: bool, channels: dict[int, Channel]):
        self.hub = hub
        self.channels = dict(channels)  # peer local rank -> Channel

    def vote(self, step: int, *, ok: bool = True) -> bool:
        """True iff every rank of the group voted ok this step."""
        mine = VOTE_OK if ok else VOTE_DRAIN
        verdict = ok
        if self.hub:
            for rank in sorted(self.channels):
                try:
                    token = self.channels[rank].recv(step=step, microbatch=rank, tag=TAG_CTL)
                    if token.numpy().tobytes() != VOTE_OK:
                        verdict = False
                except PeerDeadError:
                    verdict = False
            out = VOTE_OK if verdict else VOTE_DRAIN
            for rank in sorted(self.channels):
                try:
                    self.channels[rank].send(_u8(out), step=step, microbatch=rank, tag=TAG_CTL)
                except PeerDeadError:
                    pass  # a peer that died mid-broadcast is draining anyway
            return verdict
        # Leaf: exactly one channel (to the hub).
        ((rank, ch),) = self.channels.items()
        try:
            ch.send(_u8(mine), step=step, microbatch=rank, tag=TAG_CTL)
            token = ch.recv(step=step, microbatch=rank, tag=TAG_CTL)
        except PeerDeadError:
            return False
        return ok and token.numpy().tobytes() == VOTE_OK

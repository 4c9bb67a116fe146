"""``tpudml_torch.comm.p2p`` against ``tpudml.comm.p2p``: the MPMD wire.

- JAX's ``send_frame`` and the port's put byte-identical streams on the
  socket for f32, int32, bf16 and uint8 arrays of the same values (the
  header JSON's keys, separators and numpy dtype names, the payload, the
  CRC);
- a JAX frame decodes in the port and a port frame in JAX, bf16 included;
  a port hello reaches a JAX listener and the reverse; a drain vote
  crosses between a JAX hub and a port leaf;
- ``tests/test_mpmd.py``'s wire cases on the port: the round trip keeps
  dtype and shape, a framing mismatch keeps the stream aligned, a corrupt
  payload is a ``FramingError``, peer death is a ``PeerDeadError``, the
  edge is priced as the ``"p2p"`` kind, and the drain barrier's
  unanimity, veto and peer-death cases;
- the port decodes bf16 without ``ml_dtypes`` and never imports it.

Bitwise throughout: a frame's bytes are the contract.
"""

import ast
import json
import socket
import struct
import subprocess
import sys
import threading
import zlib
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jnp = pytest.importorskip("jax.numpy")

from tpudml.comm import p2p as jp2p  # noqa: E402

from tpudml_torch.comm import p2p  # noqa: E402
from tpudml_torch.comm.timing import collective_wire_bytes  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
EDGE = "s0r1->s1r0"


def _arrays():
    """(name, numpy array as JAX sends it, the same values as a port tensor)."""
    rng = np.random.default_rng(3)
    f32 = rng.standard_normal((3, 5)).astype(np.float32)
    i32 = rng.integers(-1000, 1000, (7,)).astype(np.int32)
    bf16 = np.asarray(jnp.asarray(rng.standard_normal((2, 4, 3)), dtype=jnp.bfloat16))
    u8 = rng.integers(0, 256, (9,)).astype(np.uint8)
    return [
        ("float32", f32, torch.from_numpy(f32.copy())),
        ("int32", i32, torch.from_numpy(i32.copy())),
        ("bfloat16", bf16, torch.from_numpy(bf16.view(np.int16).copy()).view(torch.bfloat16)),
        ("uint8", u8, torch.from_numpy(u8.copy())),
    ]


def _drain(sock) -> bytes:
    sock.settimeout(0.5)
    out = b""
    while True:
        try:
            chunk = sock.recv(65536)
        except (socket.timeout, TimeoutError):
            return out
        if not chunk:
            return out
        out += chunk


def _wire(send, arr) -> bytes:
    a, b = socket.socketpair()
    try:
        send(a, arr, step=4, microbatch=1, tag=p2p.TAG_ACT, edge=EDGE)
        return _drain(b)
    finally:
        a.close()
        b.close()


@pytest.mark.parametrize("case", range(4), ids=[c[0] for c in _arrays()])
def test_frames_are_jax_s_bytes(case):
    name, arr, t = _arrays()[case]
    want = _wire(jp2p.send_frame, arr)
    got = _wire(p2p.send_frame, t)
    assert got == want
    (hlen,) = struct.unpack("!I", got[4:8])
    assert json.loads(got[8:8 + hlen])["dtype"] == name


@pytest.mark.parametrize("case", range(4), ids=[c[0] for c in _arrays()])
def test_jax_frames_decode_in_the_port_and_back(case):
    name, arr, t = _arrays()[case]
    a, b = socket.socketpair()
    try:
        jp2p.send_frame(a, arr, step=2, microbatch=3, tag=p2p.TAG_GRAD, edge=EDGE)
        got = p2p.recv_frame(b, step=2, microbatch=3, tag=p2p.TAG_GRAD, edge=EDGE)
        assert got.dtype == t.dtype and tuple(got.shape) == arr.shape
        assert torch.equal(got, t)
        p2p.send_frame(b, t, step=2, microbatch=3, tag=p2p.TAG_GRAD, edge=EDGE)
        back = jp2p.recv_frame(a, step=2, microbatch=3, tag=p2p.TAG_GRAD, edge=EDGE)
        assert back.dtype == arr.dtype and back.shape == arr.shape
        assert back.tobytes() == arr.tobytes()
    finally:
        a.close()
        b.close()


def test_hello_and_channels_interoperate():
    """A port dialer's hello reaches a JAX listener and a JAX dialer's a
    port listener; frames then flow both ways over the accepted channels."""
    for dial, accept, ours in ((p2p.connect_channel, jp2p.accept_channels, "port"),
                               (jp2p.connect_channel, p2p.accept_channels, "jax")):
        lst = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        try:
            lst.bind(("127.0.0.1", 0))
            lst.listen(1)
            port = lst.getsockname()[1]
            out = {}
            t = threading.Thread(target=lambda: out.update(accept(lst, 1, deadline_s=10.0)))
            t.start()
            ch = dial("127.0.0.1", port, edge=EDGE, hello={"stage": 0, "rank": 1},
                      deadline_s=10.0)
            t.join(timeout=10)
            assert not t.is_alive()
            (acc, hello), = out.values()
            assert hello == {"rank": 1, "stage": 0} and list(out) == [EDGE]
            x = np.arange(6, dtype=np.float32).reshape(2, 3)
            if ours == "port":
                ch.send(torch.from_numpy(x), step=0, microbatch=0, tag=p2p.TAG_ACT)
                np.testing.assert_array_equal(acc.recv(step=0, microbatch=0, tag="act"), x)
            else:
                ch.send(x, step=0, microbatch=0, tag=p2p.TAG_ACT)
                assert torch.equal(acc.recv(step=0, microbatch=0, tag="act"),
                                   torch.from_numpy(x))
            ch.close()
            acc.close()
        finally:
            lst.close()


def test_vote_crosses_between_a_jax_hub_and_a_port_leaf():
    hub_ch, leaf_ch = socket.socketpair()
    hub = jp2p.DrainBarrier(hub=True, channels={1: jp2p.Channel(hub_ch, "ctl:s0r1")})
    leaf = p2p.DrainBarrier(hub=False, channels={1: p2p.Channel(leaf_ch, "ctl:s0r1")})
    for ok in (True, False):
        out = {}
        ts = [threading.Thread(target=lambda: out.update(hub=hub.vote(5, ok=True))),
              threading.Thread(target=lambda: out.update(leaf=leaf.vote(5, ok=ok)))]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=10)
        assert not any(t.is_alive() for t in ts)
        assert out == {"hub": ok, "leaf": ok}
    hub_ch.close()
    leaf_ch.close()


# -------------------------------------------- tests/test_mpmd.py's wire cases


def test_frame_roundtrip_preserves_dtype_and_shape():
    a, b = socket.socketpair()
    try:
        for t in (torch.arange(12, dtype=torch.float32).reshape(3, 4),
                  torch.tensor([1, -2, 3], dtype=torch.int32),
                  torch.randn(2, 3).to(torch.bfloat16),
                  torch.zeros((0, 4), dtype=torch.float32)):
            p2p.send_frame(a, t, step=7, microbatch=2, tag=p2p.TAG_ACT, edge=EDGE)
            out = p2p.recv_frame(b, step=7, microbatch=2, tag=p2p.TAG_ACT, edge=EDGE)
            assert out.dtype == t.dtype and out.shape == t.shape
            assert torch.equal(out, t)
    finally:
        a.close()
        b.close()


def test_framing_mismatch_keeps_stream_aligned():
    a, b = socket.socketpair()
    try:
        x = torch.ones(2)
        p2p.send_frame(a, x, step=0, microbatch=0, tag=p2p.TAG_ACT, edge="e")
        p2p.send_frame(a, 2 * x, step=1, microbatch=0, tag=p2p.TAG_ACT, edge="e")
        with pytest.raises(p2p.FramingError, match="frame mismatch"):
            p2p.recv_frame(b, step=5, microbatch=0, tag=p2p.TAG_ACT, edge="e")
        out = p2p.recv_frame(b, step=1, microbatch=0, tag=p2p.TAG_ACT, edge="e")
        assert torch.equal(out, 2 * x)
    finally:
        a.close()
        b.close()


def test_corrupt_payload_crc_is_a_framing_error():
    a, b = socket.socketpair()
    try:
        payload = b"\x00" * 8
        header = json.dumps(
            {"v": 1, "step": 0, "microbatch": 0, "tag": p2p.TAG_ACT, "edge": "e",
             "dtype": "float32", "shape": [2], "nbytes": len(payload),
             "crc": zlib.crc32(payload) ^ 1},
            sort_keys=True, separators=(",", ":")).encode()
        a.sendall(struct.pack("!II", p2p.FRAME_MAGIC, len(header)) + header + payload)
        with pytest.raises(p2p.FramingError, match="CRC mismatch"):
            p2p.recv_frame(b, step=0, microbatch=0, tag=p2p.TAG_ACT, edge="e")
    finally:
        a.close()
        b.close()


def test_bad_magic_and_tag_are_refused():
    a, b = socket.socketpair()
    try:
        a.sendall(struct.pack("!II", 0x1234, 0))
        with pytest.raises(p2p.FramingError, match="bad magic"):
            p2p.recv_frame(b, step=0, microbatch=0, tag=p2p.TAG_ACT, edge="e")
        with pytest.raises(ValueError, match="unknown frame tag"):
            p2p.send_frame(a, torch.ones(1), step=0, microbatch=0, tag="nope", edge="e")
    finally:
        a.close()
        b.close()


def test_the_wire_carries_host_tensors_only():
    a, b = socket.socketpair()
    try:
        meta = torch.ones(2, device="meta")
        with pytest.raises(ValueError, match="host tensors"):
            p2p.send_frame(a, meta, step=0, microbatch=0, tag=p2p.TAG_ACT, edge="e")
    finally:
        a.close()
        b.close()


def test_peer_death_is_membership_not_a_traceback():
    ch_a, ch_b = p2p.channel_pair(EDGE, timeout_s=5.0)
    ch_a.close()
    with pytest.raises(p2p.PeerDeadError) as ei:
        ch_b.recv(step=0, microbatch=0, tag=p2p.TAG_ACT)
    assert ei.value.edge == EDGE
    ch_b.close()


def test_p2p_priced_in_shared_wire_model():
    assert p2p.p2p_wire_bytes(1024) == collective_wire_bytes("p2p", 1024, 2)
    assert p2p.p2p_wire_bytes(1024) == 1024 == jp2p.p2p_wire_bytes(1024)


def test_channel_counts_and_traces_frames():
    from tpudml_torch.obs.tracer import Tracer

    tracer = Tracer()
    a, b = p2p.channel_pair(EDGE, tracer=tracer, timeout_s=5.0)
    try:
        a.send(torch.ones(4, 2), step=1, microbatch=0, tag=p2p.TAG_ACT)
        b.recv(step=1, microbatch=0, tag=p2p.TAG_ACT)
        assert a.frames == b.frames == 1 and a.bytes_sent == b.bytes_received == 32
        spans = [e for e in tracer.trace_events() if e["cat"] == "comm"]
        assert sorted(e["name"] for e in spans) == ["p2p_recv:act", "p2p_send:act"]
        assert all(e["args"]["edge"] == EDGE and e["args"]["bytes"] == 32 for e in spans)
    finally:
        a.close()
        b.close()


def _barrier_trio():
    """A dp=3 stage's ctl star: hub (local rank 0) + two leaves."""
    h1, l1 = p2p.channel_pair("ctl:s0r1", timeout_s=5.0)
    h2, l2 = p2p.channel_pair("ctl:s0r2", timeout_s=5.0)
    hub = p2p.DrainBarrier(hub=True, channels={1: h1, 2: h2})
    leaf1 = p2p.DrainBarrier(hub=False, channels={1: l1})
    leaf2 = p2p.DrainBarrier(hub=False, channels={2: l2})
    return hub, leaf1, leaf2, (h1, h2, l1, l2)


def _vote_all(parts, votes, step=0):
    out = {}

    def run(name, barrier, ok):
        out[name] = barrier.vote(step, ok=ok)

    ts = [threading.Thread(target=run, args=(n, b, v)) for (n, b), v in zip(parts.items(), votes)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=10)
    assert not any(t.is_alive() for t in ts)
    return out


@pytest.mark.parametrize("votes,want", [
    ([True, True, True], {"hub": True, "l1": True, "l2": True}),
    ([True, False, True], {"hub": False, "l1": False, "l2": False}),
])
def test_drain_barrier_votes(votes, want):
    hub, leaf1, leaf2, chans = _barrier_trio()
    assert _vote_all({"hub": hub, "l1": leaf1, "l2": leaf2}, votes) == want
    for c in chans:
        c.close()


def test_drain_barrier_peer_death_counts_as_drain():
    hub, leaf1, leaf2, chans = _barrier_trio()
    chans[3].close()  # leaf 2 dies before voting: its channel EOFs at the hub
    assert _vote_all({"hub": hub, "l1": leaf1}, [True, True]) == {"hub": False, "l1": False}
    for c in chans:
        c.close()


# -------------------------------------------------------------- no ml_dtypes


def test_bf16_frames_need_no_ml_dtypes():
    """In a process where ``ml_dtypes`` (and jax) cannot be imported, the
    port sends and decodes a bf16 frame."""
    code = (
        "import sys\n"
        "sys.modules['ml_dtypes'] = None\n"
        "sys.modules['jax'] = None\n"
        "import torch\n"
        "from tpudml_torch.comm.p2p import channel_pair\n"
        "a, b = channel_pair('e', timeout_s=5.0)\n"
        "x = torch.randn(3, 4).to(torch.bfloat16)\n"
        "a.send(x, step=0, microbatch=0, tag='act')\n"
        "y = b.recv(step=0, microbatch=0, tag='act')\n"
        "assert y.dtype == torch.bfloat16 and torch.equal(x, y)\n"
        "assert 'ml_dtypes' not in [m for m in sys.modules if sys.modules[m] is not None]\n"
        "print('ok')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_the_port_never_imports_ml_dtypes():
    bad = []
    for path in sorted((REPO / "tpudml_torch").rglob("*.py")):
        for node in ast.walk(ast.parse(path.read_text())):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                     else [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
            bad += [f"{path}:{node.lineno}" for n in names if n.split(".")[0] == "ml_dtypes"]
    assert bad == []

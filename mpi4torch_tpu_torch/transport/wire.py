"""The process transport's wire: framing and the payload codec.

**Frames.**  One frame is a pickle (protocol 5) of a plain dict with a
``"kind"`` key, whose large byte buffers travel out of band::

    8-byte big-endian pickle length | 8-byte buffer count |
    8 bytes per buffer length | pickle | buffer 0 | buffer 1 | ...

A buffer is received straight into a host array of its own (allocated
without zero-filling it) and sent straight from its memory, so the
parent forwards a payload without copying it.  Parent and workers are
the same interpreter on the same checkout (the pool spawns workers with
``sys.executable``), so the frame needs no version handshake.

**Payloads.**  A payload (what a rank deposits at a rendezvous or posts
to a mailbox, and a rank body's result) is packed in the process that
owns it into a :class:`Packed`: a pickle of the payload's structure in
which every tensor is replaced by a reference to a buffer of its own:
the tensor's elements as raw bytes (viewed, never converted, so bf16
crosses as it is), taken from a compact host tensor as it stands, else
from a detached, compact host copy.  A view contributes its own
elements, never the rest of its storage.  A frame is written before
the call that packed it returns, so the tensor cannot change under it.
The receiver :func:`unpack` s a payload onto its world's device.  The
parent's switchboard only moves :class:`Packed` objects: it never
unpickles a payload, so it never allocates device memory or copies on
behalf of a rank.

Writes to one socket are serialised by the caller's lock (the parent
answers from several threads); each socket has one reader.
"""

from __future__ import annotations

import io
import pickle
import socket
import struct
from typing import Any, List, Optional

import numpy as np
import torch

__all__ = ["Packed", "pack", "unpack", "send_frame", "recv_frame",
           "tune_socket", "WireError", "MAX_FRAME_BYTES"]

_LEN = struct.Struct(">Q")

# Ceiling of one frame part: a corrupt length prefix must not become a
# multi-terabyte allocation.
MAX_FRAME_BYTES = 1 << 36

# Parts below this size are joined into one write.
_JOIN_BELOW = 1 << 16


# Socket buffer size of both ends: a wider window than the default
# ~200 KiB cuts the context switches a large frame costs.  On an H100
# host (tools/transport_numbers.py) the default buffers made a 4 x 2^24
# float32 Allreduce on 4 workers 1.3-2.0x slower and the flagship's DP=2
# step 1.3-1.6x slower.
SOCKET_BUFFER_BYTES = 4 << 20


def tune_socket(sock) -> None:
    """Widen ``sock``'s send and receive buffers (best effort)."""
    for opt in (socket.SO_SNDBUF, socket.SO_RCVBUF):
        try:
            sock.setsockopt(socket.SOL_SOCKET, opt, SOCKET_BUFFER_BYTES)
        except OSError:
            pass


class WireError(ConnectionError):
    """The peer vanished mid-frame or sent an unframeable length."""


# ------------------------------------------------------------- payloads

class Packed:
    """A packed payload: ``meta``, the pickled structure, and ``bufs``,
    one bytes-like buffer per tensor.  Pickles with its buffers out of
    band (see :func:`send_frame`)."""

    __slots__ = ("meta", "bufs")

    def __init__(self, meta: bytes, bufs):
        self.meta = meta
        self.bufs = list(bufs)

    @property
    def nbytes(self) -> int:
        return len(self.meta) + sum(memoryview(b).nbytes for b in self.bufs)

    def __reduce__(self):
        return (Packed, (self.meta,
                         [pickle.PickleBuffer(b) for b in self.bufs]))


def _tensor_bytes(t: torch.Tensor):
    """The elements of ``t`` as a contiguous uint8 array on the host,
    covering exactly ``t`` (a view does not drag its storage along)."""
    if t.layout != torch.strided or t.is_quantized:
        raise TypeError(f"the transport wire carries strided tensors, got "
                        f"a {t.layout} tensor")
    h = t.detach()
    if h.device.type != "cpu":
        h = h.to("cpu")
    h = h.contiguous().reshape(-1)
    if h.dtype == torch.bool:
        h = h.to(torch.uint8)
    return h.view(torch.uint8).numpy()


class _Packer(pickle.Pickler):
    def __init__(self, file):
        super().__init__(file, protocol=5)
        self.bufs: List[Any] = []

    def persistent_id(self, obj):
        if isinstance(obj, torch.Tensor):
            self.bufs.append(_tensor_bytes(obj))
            return (len(self.bufs) - 1, obj.dtype, tuple(obj.shape))
        return None


class _Unpacker(pickle.Unpickler):
    def __init__(self, file, bufs, device):
        super().__init__(file)
        self._bufs = bufs
        self._device = device

    def persistent_load(self, pid):
        i, dtype, shape = pid
        flat = torch.from_numpy(self._bufs[i])
        if flat.numel() == 0:
            return torch.empty(shape, dtype=dtype, device=self._device)
        t = flat.to(torch.bool) if dtype == torch.bool else flat.view(dtype)
        t = t.reshape(shape)
        return t if self._device is None else t.to(self._device)


def pack(obj: Any) -> Packed:
    """Pack ``obj`` (any picklable structure of tensors and plain
    values) for the wire."""
    f = io.BytesIO()
    p = _Packer(f)
    p.dump(obj)
    return Packed(f.getvalue(), p.bufs)


def unpack(packed: Packed, device=None) -> Any:
    """Restore a :class:`Packed` payload, its tensors on ``device`` (None:
    on the host).  Host tensors take over the buffers received off the
    wire (arrays that own their memory) and copy any other buffer, such
    as a view of the packed tensor itself."""
    bufs = [b if isinstance(b, np.ndarray) and b.flags.owndata
            and b.flags.writeable else np.array(memoryview(b).cast("B"))
            for b in packed.bufs]
    return _Unpacker(io.BytesIO(packed.meta), bufs, device).load()


# --------------------------------------------------------------- frames

def send_frame(sock, obj: Any, lock=None) -> int:
    """Write one frame (atomic under ``lock``); returns its bytes."""
    bufs: List[pickle.PickleBuffer] = []
    data = pickle.dumps(obj, protocol=5, buffer_callback=bufs.append)
    raws = [b.raw() for b in bufs]
    head = (_LEN.pack(len(data)) + _LEN.pack(len(raws))
            + b"".join(_LEN.pack(r.nbytes) for r in raws))
    parts: List[Any] = []
    small: List[Any] = [head, data]
    for r in raws:
        if r.nbytes < _JOIN_BELOW:
            small.append(r)
        else:
            parts.append(b"".join(small))
            parts.append(r)
            small = []
    if small:
        parts.append(b"".join(small))
    if lock is not None:
        with lock:
            for p in parts:
                sock.sendall(p)
    else:
        for p in parts:
            sock.sendall(p)
    return len(head) + len(data) + sum(r.nbytes for r in raws)


def recv_frame(sock) -> Optional[dict]:
    """Read one frame; ``None`` on a clean EOF between frames.  EOF in
    the middle of a frame raises :class:`WireError`: a death while
    writing is a failure, not a shutdown."""
    head = _recv_exact(sock, 2 * _LEN.size, eof_ok=True)
    if head is None:
        return None
    n, nbufs = _LEN.unpack_from(head, 0)[0], _LEN.unpack_from(head, 8)[0]
    if n > MAX_FRAME_BYTES or nbufs > MAX_FRAME_BYTES:
        raise WireError(f"unframeable frame header ({n}, {nbufs})")
    sizes = _recv_exact(sock, nbufs * _LEN.size, eof_ok=False) \
        if nbufs else b""
    lens = [_LEN.unpack_from(sizes, 8 * i)[0] for i in range(nbufs)]
    if any(m > MAX_FRAME_BYTES for m in lens):
        raise WireError(f"frame buffer length exceeds {MAX_FRAME_BYTES}")
    data = _recv_exact(sock, n, eof_ok=False)
    bufs = [_recv_exact(sock, m, eof_ok=False, into=np.empty(m, np.uint8))
            for m in lens]
    return pickle.loads(data, buffers=bufs)


def _recv_exact(sock, n: int, eof_ok: bool, into=None):
    buf = bytearray(n) if into is None else into
    view = memoryview(buf).cast("B")
    got = 0
    while got < n:
        try:
            k = sock.recv_into(view[got:], min(n - got, 1 << 22))
        except (ConnectionResetError, BrokenPipeError, OSError) as e:
            if eof_ok and got == 0:
                return None
            raise WireError(f"connection lost mid-frame: {e}") from e
        if k == 0:
            if eof_ok and got == 0:
                return None
            raise WireError("peer closed the connection mid-frame")
        got += k
    return buf

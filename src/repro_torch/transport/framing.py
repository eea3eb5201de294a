"""Framed wire format for streaming split-inference sessions.

Everything that crosses the edge<->cloud socket is a *frame*:

    <HBBIII I>  magic  ver  type  session  seq  length  crc32(payload)
    payload[length]

* ``magic`` (0xC01D) + CRC make torn or corrupted streams fail loudly
  instead of desynchronizing the parser.
* ``session`` multiplexes concurrent tensors over one connection; frames
  of different sessions interleave freely, ordering only matters within
  a session (and chunk payloads carry their own chunk id anyway).
* ``seq`` is a per-session counter used for diagnostics.
* frame types: HEADER (stream meta + self-describing codec header),
  CHUNK (one entropy-coded chunk), END (end-of-tensor marker, payload =
  ``<I`` chunk count), RESULT (cloud -> edge arrays), FEEDBACK
  (cloud -> edge link stats for the rate controller), ERROR (structured
  code + retryable flag + message, see :mod:`repro_torch.transport.errors`;
  legacy bare utf-8 text still parses), METRICS (edge -> cloud: empty
  request; cloud -> edge: JSON snapshot of the cloud's metrics
  registry -- telemetry only, never tensor bytes), HELLO (authenticated
  session establishment + resume handshake), PING (liveness echo).

:class:`FrameReader` is an incremental parser: feed it arbitrary byte
slices (single bytes included) and iterate complete frames.  See
DESIGN.md ("Transport framing and streaming sessions") for the protocol
rules built on top.
"""

from __future__ import annotations

import dataclasses
import struct
import zlib

import numpy as np

MAGIC = 0xC01D
VERSION = 1
_FRAME_FMT = "<HBBIII"          # magic, ver, type, session, seq, length
_FRAME_HEAD = struct.calcsize(_FRAME_FMT) + 4  # + crc32
MAX_PAYLOAD = 1 << 26           # 64 MiB sanity bound per frame

FT_HEADER = 1
FT_CHUNK = 2
FT_END = 3
FT_RESULT = 4
FT_FEEDBACK = 5
FT_ERROR = 6
FT_METRICS = 7
# session establishment + resume (edge -> cloud: JSON {token, auth};
# cloud -> edge: JSON ack {ok, resumed, acked}) -- must precede the
# first HEADER when the server requires authentication
FT_HELLO = 8
# liveness probe: the receiver echoes the payload back in an FT_PING
# frame (dispatcher <-> worker heartbeats)
FT_PING = 9


class FramingError(ValueError):
    """Corrupted or malformed wire data (bad magic, CRC, version)."""


@dataclasses.dataclass
class Frame:
    ftype: int
    session: int
    seq: int
    payload: bytes

    def encode(self) -> bytes:
        if len(self.payload) > MAX_PAYLOAD:
            raise FramingError(f"payload too large: {len(self.payload)}")
        head = struct.pack(_FRAME_FMT, MAGIC, VERSION, self.ftype,
                           self.session, self.seq, len(self.payload))
        return head + struct.pack("<I", zlib.crc32(self.payload)) \
            + self.payload


def encode_frame(ftype: int, session: int, seq: int,
                 payload: bytes = b"") -> bytes:
    return Frame(ftype, session, seq, payload).encode()


class FrameReader:
    """Incremental frame parser tolerant of arbitrary delivery boundaries.

    >>> r = FrameReader()
    >>> for b in wire_bytes: r.feed(bytes([b]))   # torn delivery is fine
    >>> frames = list(r)
    """

    def __init__(self) -> None:
        self._buf = bytearray()

    def feed(self, data: bytes) -> None:
        self._buf.extend(data)

    @property
    def pending_bytes(self) -> int:
        return len(self._buf)

    def _try_pop(self) -> Frame | None:
        if len(self._buf) < _FRAME_HEAD:
            return None
        magic, ver, ftype, session, seq, length = struct.unpack_from(
            _FRAME_FMT, self._buf)
        if magic != MAGIC:
            raise FramingError(f"bad magic 0x{magic:04x}")
        if ver != VERSION:
            raise FramingError(f"unsupported frame version {ver}")
        if length > MAX_PAYLOAD:
            raise FramingError(f"frame length {length} exceeds bound")
        if len(self._buf) < _FRAME_HEAD + length:
            return None
        (crc,) = struct.unpack_from("<I", self._buf,
                                    struct.calcsize(_FRAME_FMT))
        payload = bytes(self._buf[_FRAME_HEAD:_FRAME_HEAD + length])
        if zlib.crc32(payload) != crc:
            raise FramingError(f"payload CRC mismatch (session {session}, "
                               f"seq {seq})")
        del self._buf[:_FRAME_HEAD + length]
        return Frame(ftype, session, seq, payload)

    def __iter__(self):
        while True:
            frame = self._try_pop()
            if frame is None:
                return
            yield frame


# -- small array (de)serializer for RESULT payloads --------------------------

_DTYPES = {0: np.dtype("<f4"), 1: np.dtype("<i4"), 2: np.dtype("<u1"),
           3: np.dtype("<f2")}
_DTYPE_IDS = {v: k for k, v in _DTYPES.items()}


def pack_arrays(arrays: list[np.ndarray]) -> bytes:
    """``<B n>`` then per array ``<BB dims...>`` dtype-id, ndim, u32 dims,
    raw little-endian bytes."""
    out = [struct.pack("<B", len(arrays))]
    for a in arrays:
        a = np.ascontiguousarray(a)
        dt = a.dtype.newbyteorder("<")
        if dt not in _DTYPE_IDS:
            raise FramingError(f"unsupported dtype {a.dtype}")
        out.append(struct.pack("<BB", _DTYPE_IDS[dt], a.ndim))
        out.append(np.asarray(a.shape, "<u4").tobytes())
        out.append(a.astype(dt).tobytes())
    return b"".join(out)


def unpack_arrays(data: bytes) -> list[np.ndarray]:
    (n,) = struct.unpack_from("<B", data)
    off = 1
    out = []
    for _ in range(n):
        did, ndim = struct.unpack_from("<BB", data, off)
        off += 2
        dims = tuple(int(d) for d in np.frombuffer(data, "<u4", ndim, off))
        off += 4 * ndim
        dt = _DTYPES[did]
        count = int(np.prod(dims)) if dims else 1
        arr = np.frombuffer(data, dt, count, off).reshape(dims)
        off += count * dt.itemsize
        out.append(arr)
    return out

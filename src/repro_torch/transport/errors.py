"""Structured frame-level error codes (FT_ERROR payloads).

The seed transport shipped errors as bare stringified exceptions, which
left the edge unable to tell "the cloud is briefly saturated, try again"
from "this stream is corrupt, give up".  Every FT_ERROR payload now
carries a typed triple::

    <B magic=0xEE> <H code> <B flags> <utf-8 message>

``flags`` bit 0 is the *retryable* bit: the sender's statement that the
same submission may succeed later (admission-control sheds, a worker
restarting or draining).  Fatal codes (corrupt stream, protocol
violation, auth failure) mean the client must not replay the same bytes.

Legacy bare-text payloads (streams from a pre-hardening peer) still
parse: :func:`decode_error` falls back to ``E_UNSPECIFIED`` + the raw
text, non-retryable -- the conservative reading.

The codes travel on control frames only; codec stream bytes (HEADER /
CHUNK payloads, the conformance-gated wire format) are untouched.
"""

from __future__ import annotations

import struct

# -- codes --------------------------------------------------------------------

E_UNSPECIFIED = 0        # legacy bare-text error (unknown cause)
E_PROTOCOL = 1           # malformed frames / protocol violation   (fatal)
E_CORRUPT_STREAM = 2     # CRC / entropy-decode failure            (fatal)
E_DECODE = 3             # reconstruction or tail_fn failed        (fatal)
E_UNAUTHORIZED = 4       # HELLO auth missing or rejected          (fatal)
E_BUSY = 5               # admission control shed                  (retryable)
E_WORKER_RESTART = 6     # worker died / restarting mid-session    (retryable)
E_SHUTDOWN = 7           # planned drain: no new sessions here     (retryable)
E_DEADLINE = 8           # client-side submit deadline expired     (fatal)

#: codes whose *default* retryable flag is set (the wire flag wins when
#: a peer says otherwise)
RETRYABLE_CODES = frozenset({E_BUSY, E_WORKER_RESTART, E_SHUTDOWN})

CODE_NAMES = {
    E_UNSPECIFIED: "UNSPECIFIED",
    E_PROTOCOL: "PROTOCOL",
    E_CORRUPT_STREAM: "CORRUPT_STREAM",
    E_DECODE: "DECODE",
    E_UNAUTHORIZED: "UNAUTHORIZED",
    E_BUSY: "BUSY",
    E_WORKER_RESTART: "WORKER_RESTART",
    E_SHUTDOWN: "SHUTDOWN",
    E_DEADLINE: "DEADLINE",
}

_ERR_MAGIC = 0xEE
_ERR_FMT = "<BHB"        # magic, code, flags
_FLAG_RETRYABLE = 1


class TransportError(RuntimeError):
    """Typed transport failure.

    ``code`` is one of the ``E_*`` constants; ``retryable`` says whether
    the same submission may be retried (BUSY, worker restart, drain).
    """

    def __init__(self, message: str, *, code: int = E_UNSPECIFIED,
                 retryable: bool | None = None) -> None:
        super().__init__(message)
        self.code = code
        self.retryable = (code in RETRYABLE_CODES if retryable is None
                          else bool(retryable))

    @property
    def code_name(self) -> str:
        return CODE_NAMES.get(self.code, f"E_{self.code}")

    def __str__(self) -> str:  # "[BUSY retryable] queue full"
        kind = "retryable" if self.retryable else "fatal"
        return f"[{self.code_name} {kind}] {super().__str__()}"


def encode_error(code: int, message: str,
                 retryable: bool | None = None) -> bytes:
    """FT_ERROR payload bytes for a typed error."""
    if retryable is None:
        retryable = code in RETRYABLE_CODES
    flags = _FLAG_RETRYABLE if retryable else 0
    return struct.pack(_ERR_FMT, _ERR_MAGIC, code, flags) \
        + message.encode("utf-8", "replace")


def decode_error(payload: bytes) -> TransportError:
    """Parse an FT_ERROR payload (structured or legacy bare text)."""
    if len(payload) >= struct.calcsize(_ERR_FMT) \
            and payload[0] == _ERR_MAGIC:
        _, code, flags = struct.unpack_from(_ERR_FMT, payload)
        msg = payload[struct.calcsize(_ERR_FMT):].decode("utf-8", "replace")
        return TransportError(msg, code=code,
                              retryable=bool(flags & _FLAG_RETRYABLE))
    return TransportError(payload.decode("utf-8", "replace"),
                          code=E_UNSPECIFIED, retryable=False)


def error_for_exception(exc: BaseException) -> tuple[int, bool]:
    """(code, retryable) classification for a server-side exception."""
    if isinstance(exc, TransportError):
        return exc.code, exc.retryable
    name = type(exc).__name__
    text = str(exc).lower()
    if name == "FramingError" or "crc" in text or "magic" in text:
        return E_CORRUPT_STREAM, False
    if isinstance(exc, ValueError):
        # stream-shape violations (bad chunk ids, END mismatch, ...)
        return E_CORRUPT_STREAM, False
    return E_DECODE, False

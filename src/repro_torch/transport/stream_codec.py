"""Chunked tensor <-> frame stream glue.

Maps :meth:`FeatureCodec.encode_stream` payloads onto wire frames
(HEADER, CHUNK..., END) for one session, and reassembles/decodes the
frames on the receiving side with :class:`TensorAssembler` --
entropy-decoding arrived chunks in batches (one batched rANS step loop
per ``STREAM_CHUNK_BATCH`` chunks, mirroring the batched send side), so
decode overlaps the transfer and only the final dequantize plus at most
one remainder batch waits for END.

FEEDBACK frame payloads (link stats the cloud reports back for the
edge-side rate controller) are also defined here so both halves share
one layout.
"""

from __future__ import annotations

import dataclasses
import struct

import numpy as np

from ..core.codec import STREAM_CHUNK_BATCH, ChunkStreamDecoder, FeatureCodec
from .framing import (FT_CHUNK, FT_END, FT_FEEDBACK, FT_HEADER, Frame,
                      encode_frame)

# Chunk size balances pipeline granularity against per-chunk coder cost:
# the vectorized coder's python step loop runs ~bits/lanes iterations with
# lanes capped by payload size, so many small chunks multiply loop
# overhead -- though the batched chunk encoder (one rANS step loop per
# STREAM_CHUNK_BATCH chunks, see core/rans.encode_planes_batch) now
# amortizes most of it.  256Ki elements still gives a multi-MB tensor a
# several-stage pipeline at near-one-shot encode cost.  Tiled codecs
# round the chunk size up to the tile run length in coded order
# (TilePlan.align_chunk_elems: the uniform block run when every spatial
# block -- flat 1-D run or 2-D row x column tile -- has the same element
# count, a whole channel row otherwise), so chunk boundaries align to
# tiles and each chunk's chunk-static entropy probabilities see
# tile-homogeneous statistics; ChunkStreamDecoder stays bit-exact and
# out-of-order tolerant either way (chunks address element ranges, not
# tiles).
DEFAULT_CHUNK_ELEMS = 1 << 18

_END_FMT = "<I"            # n_chunks sent (completeness check)
_FEEDBACK_FMT = "<ddII"    # recv_bytes_per_s, decode_s, queue_depth, sessions


def tensor_to_frames(codec: FeatureCodec, x: np.ndarray, session: int,
                     chunk_elems: int = DEFAULT_CHUNK_ELEMS,
                     coder_mode: str = "auto"):
    """Yield wire-ready frame bytes for one tensor (HEADER, CHUNKs, END).

    A generator on purpose: the sender can put each frame on the socket
    while the next chunk is still being entropy-coded.
    """
    seq = 0
    for payload in codec.encode_stream(x, chunk_elems=chunk_elems,
                                       coder_mode=coder_mode):
        ftype = FT_HEADER if seq == 0 else FT_CHUNK
        yield encode_frame(ftype, session, seq, payload)
        seq += 1
    yield encode_frame(FT_END, session, seq, struct.pack(_END_FMT, seq - 1))


def payloads_to_frames(payloads: list[bytes], session: int) -> list[bytes]:
    """Wire frames (HEADER, CHUNKs, END) for an already-encoded payload
    list (the cross-session batcher's per-session output).  Frame-for-
    frame identical to :func:`tensor_to_frames` over the same payloads --
    the batched and per-session send paths put the same bytes on the
    wire."""
    frames = [encode_frame(FT_HEADER if i == 0 else FT_CHUNK, session, i, p)
              for i, p in enumerate(payloads)]
    frames.append(encode_frame(FT_END, session, len(payloads),
                               struct.pack(_END_FMT, len(payloads) - 1)))
    return frames


class TensorAssembler:
    """Per-session receiver: feed frames, get the reconstructed tensor.

    ``feed`` returns the reconstruction (a float32 ndarray, bit-exact
    with the in-process ``codec.decode(codec.encode(x))`` path) when the
    END frame completes the tensor, else None.  Chunk frames are
    entropy-decoded in arrival batches (see :class:`ChunkStreamDecoder`).

    ``defer=True`` is the serving-tick mode: ``feed`` never decodes or
    finishes (it always returns None; chunks accumulate in a
    ``chunk_batch=0`` decoder for a cross-session ``flush_decoders``
    drain), completion is polled via :attr:`ready` and the reconstruction
    fetched with :meth:`finish`.  ``header_cache`` shares parsed headers
    across a worker's sessions.
    """

    def __init__(self, *, backend=None, ecsq=None, defer: bool = False,
                 header_cache=None) -> None:
        self._backend = backend
        self._ecsq = ecsq
        self._defer = defer
        self._header_cache = header_cache
        self._dec: ChunkStreamDecoder | None = None
        self._end_chunks: int | None = None
        self.chunk_bytes = 0          # coded payload bytes seen so far

    @property
    def started(self) -> bool:
        return self._dec is not None

    @property
    def decoder(self) -> ChunkStreamDecoder | None:
        """The underlying stream decoder (what a cross-session drain
        registers with a
        :class:`~repro_torch.serving.batcher.DecodeBatcher`)."""
        return self._dec

    @property
    def n_elems(self) -> int:
        if self._dec is None:
            raise ValueError("no HEADER frame yet")
        return self._dec.header.n_elems

    @property
    def ready(self) -> bool:
        """END seen and every chunk arrived (entropy work may still be
        pending in deferred mode)."""
        return (self._end_chunks is not None and self._dec is not None
                and self._dec.complete)

    def finish(self) -> np.ndarray:
        """Reconstruct (deferred mode; drains any still-pending chunks)."""
        if not self.ready:
            raise ValueError("tensor stream not complete")
        return self._dec.finish()

    def _maybe_finish(self) -> np.ndarray | None:
        if self._defer or not self.ready:
            return None
        return self._dec.finish()

    def feed(self, frame: Frame) -> np.ndarray | None:
        if frame.ftype == FT_HEADER:
            if self._dec is not None:
                raise ValueError("duplicate HEADER frame")
            self._dec = ChunkStreamDecoder(
                frame.payload, backend=self._backend, ecsq=self._ecsq,
                chunk_batch=0 if self._defer else STREAM_CHUNK_BATCH,
                header_cache=self._header_cache)
            self.chunk_bytes += len(frame.payload)
            return self._maybe_finish()
        if frame.ftype == FT_CHUNK:
            if self._dec is None:
                raise ValueError("CHUNK before HEADER")
            self._dec.add_chunk(frame.payload)
            self.chunk_bytes += len(frame.payload)
            return self._maybe_finish()
        if frame.ftype == FT_END:
            (n_chunks,) = struct.unpack(_END_FMT, frame.payload)
            if self._dec is None or n_chunks != self._dec.n_chunks:
                raise ValueError("END does not match stream header")
            self._end_chunks = n_chunks
            return self._maybe_finish()
        raise ValueError(f"unexpected frame type {frame.ftype} in tensor "
                         "stream")


@dataclasses.dataclass
class Feedback:
    """Cloud-side link stats, one per completed tensor (FEEDBACK frames)."""

    recv_bytes_per_s: float
    decode_s: float
    queue_depth: int
    active_sessions: int

    def encode(self, session: int, seq: int) -> bytes:
        payload = struct.pack(_FEEDBACK_FMT, self.recv_bytes_per_s,
                              self.decode_s, self.queue_depth,
                              self.active_sessions)
        return encode_frame(FT_FEEDBACK, session, seq, payload)

    @classmethod
    def decode(cls, frame: Frame) -> "Feedback":
        if frame.ftype != FT_FEEDBACK:
            raise ValueError("not a FEEDBACK frame")
        r, d, q, s = struct.unpack(_FEEDBACK_FMT, frame.payload)
        return cls(recv_bytes_per_s=r, decode_s=d, queue_depth=q,
                   active_sessions=s)

"""Deterministic fault injection at the frame-writer seam.

Chaos scenarios (lossy links, flaky middleboxes, dying workers) must be
*reproducible* to live in tier-1, so faults are injected at one
deterministic seam: a :class:`ChaosWriter` wraps an asyncio
``StreamWriter``, splits the outgoing byte stream back into frames (the
only unit the transport ever writes), and applies a :class:`FaultPlan`
keyed by the per-writer frame counter -- frame *i* is dropped,
duplicated, corrupted, delayed, or the connection is reset after *i*
frames, identically on every run.  Rate-based faults draw from a seeded
RNG, so they too replay bit-identically.

Config is programmatic (tests pass a ``FaultPlan``) or env-driven::

    REPRO_CHAOS='{"client": {"reset_after": 5}, "server": {"drop_frames": [3]}}'

keys are injection *roles*: ``client`` (EdgeClient's writer), ``server``
(CloudServer's per-connection writer), ``edge`` / ``upstream`` (the
dispatcher's two sides).  Worker-kill chaos is a process-level fault and
lives on the dispatcher (:meth:`~repro_torch.transport.dispatcher.Dispatcher.
kill_worker`), not here.

Corruption flips one payload byte of the already-CRC'd frame, so the
receiver sees a genuine CRC mismatch -- exactly the wire fault the
framing layer exists to catch.  Nothing here touches codec payload
construction; golden streams are unaffected.
"""

from __future__ import annotations

import asyncio
import dataclasses
import json
import os
import random
import struct

from .framing import _FRAME_FMT, _FRAME_HEAD

CHAOS_ENV = "REPRO_CHAOS"


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """What to do to the frame stream of one writer.

    Indices count frames written through this writer, starting at 0.
    ``*_rate`` faults draw per-frame from ``random.Random(seed)`` --
    deterministic for a fixed seed and frame sequence.
    """

    drop_frames: tuple[int, ...] = ()        # swallow frame i entirely
    dup_frames: tuple[int, ...] = ()         # write frame i twice
    corrupt_frames: tuple[int, ...] = ()     # flip a payload byte of i
    delay_frames: tuple[tuple[int, float], ...] = ()   # (i, seconds)
    reset_after: int | None = None           # abort the conn after i frames
    drop_rate: float = 0.0
    corrupt_rate: float = 0.0
    seed: int = 0

    @classmethod
    def from_env(cls, role: str,
                 env: str | None = None) -> "FaultPlan | None":
        """Plan for ``role`` out of the ``REPRO_CHAOS`` JSON (or None)."""
        raw = env if env is not None else os.environ.get(CHAOS_ENV)
        if not raw:
            return None
        spec = json.loads(raw).get(role)
        if not spec:
            return None
        kw = dict(spec)
        for key in ("drop_frames", "dup_frames", "corrupt_frames"):
            if key in kw:
                kw[key] = tuple(int(i) for i in kw[key])
        if "delay_frames" in kw:
            kw["delay_frames"] = tuple(
                (int(i), float(s)) for i, s in
                (kw["delay_frames"].items()
                 if isinstance(kw["delay_frames"], dict)
                 else kw["delay_frames"]))
        return cls(**kw)

    def is_noop(self) -> bool:
        return not (self.drop_frames or self.dup_frames
                    or self.corrupt_frames or self.delay_frames
                    or self.reset_after is not None
                    or self.drop_rate or self.corrupt_rate)


def _corrupt(frame: bytes) -> bytes:
    """Flip one byte *after* the CRC was computed: payload if any, else
    the CRC itself -- the receiver must see a framing-level fault."""
    out = bytearray(frame)
    out[-1] ^= 0xFF
    return bytes(out)


class ChaosReset(ConnectionResetError):
    """The fault plan reset this connection (so tests can tell an
    injected reset from a real one)."""


class ChaosWriter:
    """StreamWriter proxy applying a :class:`FaultPlan` frame-by-frame.

    Only whole frames ever cross ``write`` in this transport, but the
    splitter is incremental anyway (a torn write worst-case defers one
    frame to the next write call).  ``delay_frames`` are realized inside
    :meth:`drain` (every frame write in the transport is followed by an
    awaited drain, so delays land on the wire in order).
    """

    def __init__(self, writer: asyncio.StreamWriter, plan: FaultPlan,
                 on_fault=None) -> None:
        self._w = writer
        self.plan = plan
        self._rng = random.Random(plan.seed)
        self._buf = bytearray()
        self._n = 0                  # frames seen (pre-fault count)
        self._delay_s = 0.0          # accumulated delay for next drain
        self._reset = False
        self._on_fault = on_fault    # callable(kind: str, frame_idx: int)
        self.faults: list[tuple[str, int]] = []
        self._delays = dict(plan.delay_frames)

    # -- proxy ----------------------------------------------------------------

    def __getattr__(self, name):
        return getattr(self._w, name)

    @property
    def transport(self):
        return self._w.transport

    def _note(self, kind: str, idx: int) -> None:
        self.faults.append((kind, idx))
        if self._on_fault is not None:
            self._on_fault(kind, idx)

    def _split_frames(self):
        """Pop complete raw frames off the buffer (no CRC validation --
        faults are applied to whatever bytes the sender produced)."""
        while len(self._buf) >= _FRAME_HEAD:
            length = struct.unpack_from(_FRAME_FMT, self._buf)[5]
            total = _FRAME_HEAD + length
            if len(self._buf) < total:
                return
            frame = bytes(self._buf[:total])
            del self._buf[:total]
            yield frame

    def write(self, data: bytes) -> None:
        if self._reset:
            raise ChaosReset("fault injection: connection reset")
        self._buf.extend(data)
        for frame in self._split_frames():
            i = self._n
            self._n += 1
            if self.plan.reset_after is not None \
                    and i >= self.plan.reset_after:
                self._note("reset", i)
                self._reset = True
                self._w.transport.abort()
                raise ChaosReset("fault injection: connection reset "
                                 f"after {self.plan.reset_after} frames")
            if i in self._delays:
                self._note("delay", i)
                self._delay_s += self._delays[i]
            if i in self.plan.drop_frames or (
                    self.plan.drop_rate
                    and self._rng.random() < self.plan.drop_rate):
                self._note("drop", i)
                continue
            if i in self.plan.corrupt_frames or (
                    self.plan.corrupt_rate
                    and self._rng.random() < self.plan.corrupt_rate):
                self._note("corrupt", i)
                frame = _corrupt(frame)
            self._w.write(frame)
            if i in self.plan.dup_frames:
                self._note("dup", i)
                self._w.write(frame)

    async def drain(self) -> None:
        if self._delay_s:
            delay, self._delay_s = self._delay_s, 0.0
            await asyncio.sleep(delay)
        if self._reset:
            raise ChaosReset("fault injection: connection reset")
        await self._w.drain()

    def close(self) -> None:
        self._w.close()

    async def wait_closed(self) -> None:
        try:
            await self._w.wait_closed()
        except ConnectionError:
            pass


def wrap_writer(writer: asyncio.StreamWriter, role: str,
                plan: FaultPlan | None = None, on_fault=None):
    """The transport's single injection hook: returns the writer
    unchanged unless a plan was passed or ``REPRO_CHAOS`` names ``role``.
    """
    if plan is None:
        plan = FaultPlan.from_env(role)
    if plan is None or plan.is_noop():
        return writer
    return ChaosWriter(writer, plan, on_fault=on_fault)

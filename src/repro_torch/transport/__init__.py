"""Streaming split-inference transport: chunked bitstream framing, async
edge<->cloud sessions, and bandwidth-adaptive rate control.

Layering (bottom up):

  framing      -- length-prefixed CRC'd frames, incremental FrameReader
  errors       -- structured FT_ERROR codes (retryable vs fatal)
  faultinject  -- deterministic chaos at the frame-writer seam
  stream_codec -- tensor <-> frame streams (chunked FeatureCodec payloads)
  rate_control -- bits/element budget tracking + quantizer rung selection
  server       -- asyncio cloud half (incremental decode + model tail)
  client       -- asyncio edge half (multiplexed sessions, retry/resume,
                  sync facade)
  worker       -- standalone CloudServer subprocess entrypoint
  dispatcher   -- session-affine front-end over a pool of workers

The chunked codec itself (``FeatureCodec.encode_stream`` /
``decode_stream``) lives in :mod:`repro_torch.core.codec`; this package is the
wire protocol and session machinery around it.  See DESIGN.md,
"Transport framing and streaming sessions" and "Hardened scale-out
serving".
"""

from .client import (EdgeClient, RetryPolicy, SubmitResult, SyncEdgeClient,
                     TransportError)
from .dispatcher import Dispatcher
from .errors import (CODE_NAMES, E_BUSY, E_CORRUPT_STREAM, E_DEADLINE,
                     E_DECODE, E_PROTOCOL, E_SHUTDOWN, E_UNAUTHORIZED,
                     E_UNSPECIFIED, E_WORKER_RESTART, RETRYABLE_CODES,
                     decode_error, encode_error)
from .faultinject import ChaosReset, ChaosWriter, FaultPlan, wrap_writer
from .framing import (FT_CHUNK, FT_END, FT_ERROR, FT_FEEDBACK, FT_HEADER,
                      FT_HELLO, FT_METRICS, FT_PING, FT_RESULT, Frame,
                      FrameReader, FramingError, encode_frame, pack_arrays,
                      unpack_arrays)
from .rate_control import (DEFAULT_LADDER, CodecBank, RateControlConfig,
                           RateController, Rung, as_rung, bank_cache_stats,
                           clear_bank_cache, rung_of_codec, shared_bank)
from .server import CloudServer, hello_auth
from .stream_codec import (DEFAULT_CHUNK_ELEMS, Feedback, TensorAssembler,
                           payloads_to_frames, tensor_to_frames)

__all__ = [
    "EdgeClient", "SyncEdgeClient", "SubmitResult", "TransportError",
    "RetryPolicy",
    "Frame", "FrameReader", "FramingError", "encode_frame",
    "pack_arrays", "unpack_arrays",
    "FT_HEADER", "FT_CHUNK", "FT_END", "FT_RESULT", "FT_FEEDBACK",
    "FT_ERROR", "FT_METRICS", "FT_HELLO", "FT_PING",
    "E_UNSPECIFIED", "E_PROTOCOL", "E_CORRUPT_STREAM", "E_DECODE",
    "E_UNAUTHORIZED", "E_BUSY", "E_WORKER_RESTART", "E_SHUTDOWN",
    "E_DEADLINE", "RETRYABLE_CODES", "CODE_NAMES",
    "encode_error", "decode_error",
    "FaultPlan", "ChaosWriter", "ChaosReset", "wrap_writer",
    "CodecBank", "RateControlConfig", "RateController", "DEFAULT_LADDER",
    "Rung", "as_rung", "rung_of_codec",
    "shared_bank", "bank_cache_stats", "clear_bank_cache",
    "CloudServer", "hello_auth", "Dispatcher",
    "TensorAssembler", "tensor_to_frames",
    "payloads_to_frames", "Feedback", "DEFAULT_CHUNK_ELEMS",
]

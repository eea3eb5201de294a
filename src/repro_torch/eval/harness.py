"""End-to-end accuracy harness: the paper's headline claim, measured.

For each :class:`~repro_torch.eval.scenarios.Scenario` the harness runs
*real* split inference -- ``models.forward_head`` on the edge side, a
:class:`~repro_torch.core.FeatureCodec` round trip at the boundary,
``models.forward_from_boundary`` on the cloud side -- and reports
task-metric degradation against the uncompressed split at the
**measured** wire rate, not a nominal log2(N):

* ``degradation``: 1 - top-1 next-token agreement with the uncompressed
  reference, scored over *decisive* tokens -- those whose reference
  top-2 logit margin exceeds ``Scenario.decisive_margin``.  On a
  smoke-scale random-init model a near-tie argmax flips under
  infinitesimal perturbation; excluding those ties makes the task
  metric stable (0.0 means task-indistinguishable) while any real
  codec failure still registers, because it moves logits far past the
  margin.  ``raw_degradation`` scores every token for reference.
* ``bits_per_elem``: coded stream bytes x 8 / boundary elements, from
  the actual ``encode_stream`` bytes (headers and all).
* ``logit_rmse``: a secondary, finer-grained signal for the monotone
  ladder gates (top-1 agreement saturates at small N on easy tokens).

One :func:`run_scenario` call sweeps the scenario's full
rungs x clip-modes matrix against a single calibration pass per clip
mode, re-using the head's boundaries and the uncompressed tail's logits
across every case.  The model runs on ``device`` (the card unless the
CPU is asked for) with random weights from a generator seeded with the
scenario's seed; boundaries cross to the host as float32 numpy, as in
the JAX package.  A ``transport="loopback"`` scenario sends every
boundary through a real localhost socket (a CloudServer on its own
event-loop thread and a blocking edge client) and counts the wire's
bytes; the server dequantizes on the codec's backend.
"""

from __future__ import annotations

import dataclasses
import json
import time
from typing import Any

import numpy as np
import torch

from .. import models
from ..core import CodecConfig, calibrate
from ..core.codec import FeatureCodec
from .scenarios import Scenario

__all__ = ["CaseResult", "ScenarioReport", "codec_config_for",
           "run_matrix", "run_scenario"]


@dataclasses.dataclass(frozen=True)
class CaseResult:
    """One (rung, clip_mode) cell of a scenario's sweep."""

    scenario: str
    rung: int
    clip_mode: str
    bits_per_elem: float
    degradation: float           # 1 - top-1 agreement, decisive tokens
    agreement: float             # over decisive tokens
    raw_degradation: float       # 1 - top-1 agreement, every token
    raw_agreement: float
    n_decisive: int
    logit_rmse: float
    coded_bytes: int
    n_elems: int

    def to_dict(self) -> dict[str, Any]:
        return dataclasses.asdict(self)


@dataclasses.dataclass(frozen=True)
class ScenarioReport:
    scenario: Scenario
    cases: tuple[CaseResult, ...]
    split_after: int             # the boundary actually evaluated
    n_tokens: int                # predictions scored per case
    elapsed_s: float

    def to_dict(self) -> dict[str, Any]:
        return {"scenario": json.loads(self.scenario.to_json()),
                "split_after": self.split_after,
                "n_tokens": self.n_tokens,
                "elapsed_s": self.elapsed_s,
                "cases": [c.to_dict() for c in self.cases]}

    def case(self, rung: int, clip_mode: str) -> CaseResult:
        for c in self.cases:
            if c.rung == rung and c.clip_mode == clip_mode:
                return c
        raise KeyError(f"no case (rung={rung}, clip_mode={clip_mode!r})")


def codec_config_for(sc: Scenario, rung: int, clip_mode: str,
                     backend: str | None = None) -> CodecConfig:
    """Map a scenario cell onto a :class:`CodecConfig`.

    Boundary activations are roughly symmetric (residual-stream, not
    post-ReLU), so cmin is never pinned to zero except by ACIQ itself,
    which is exactly the paper's point about that baseline.
    """
    kw: dict[str, Any] = dict(
        n_levels=rung, clip_mode=clip_mode, constrain_cmin_zero=False,
        use_ecsq=sc.use_ecsq, backend=backend,
        calib_sample_cap=sc.calib_sample_cap)
    if sc.granularity == "channel":
        kw.update(granularity="channel", channel_axis=-1,
                  channel_group_size=sc.channel_group_size)
    elif sc.granularity == "tile":
        kw.update(granularity="tile", channel_axis=-1,
                  channel_group_size=sc.channel_group_size,
                  spatial_block_size=sc.spatial_block_size)
    elif sc.granularity == "tile2d":
        kw.update(granularity="tile", channel_axis=-1,
                  channel_group_size=sc.channel_group_size,
                  spatial_block_hw=sc.spatial_block_hw)
    return CodecConfig(**kw)


def _token_batches(sc: Scenario, vocab: int) -> tuple[np.ndarray, np.ndarray]:
    """Deterministic eval + calibration token batches (same shape, so
    tile plans built on the calibration tensor match the eval tensors)."""
    rng = np.random.default_rng(sc.seed)
    ev = rng.integers(0, vocab, (sc.n_eval_batches, sc.batch, sc.seq_len),
                      dtype=np.int64).astype(np.int32)
    cal = rng.integers(0, vocab, (sc.batch, sc.seq_len),
                       dtype=np.int64).astype(np.int32)
    return ev, cal


def _roundtrip_inproc(codec: FeatureCodec, x: np.ndarray
                      ) -> tuple[np.ndarray, int]:
    """Encode/decode through the streaming path; returns (recon, bytes).
    The byte count sums every payload -- stream header, chunk headers
    and entropy bytes -- i.e. what would actually cross the wire."""
    payloads = list(codec.encode_stream(x))
    return (codec.decode_stream(payloads),
            sum(len(p) for p in payloads))


class _LoopbackLink:
    """A real CloudServer on a daemon-thread event loop plus a blocking
    edge client: boundary tensors cross an actual socket and the rate is
    the client's wire accounting.  The server dequantizes on the codec's
    backend."""

    def __init__(self, codec: FeatureCodec):
        import asyncio
        import threading

        from ..serving import TickConfig
        from ..transport import CloudServer, SyncEdgeClient

        self._loop = asyncio.new_event_loop()
        self._thread = threading.Thread(target=self._loop.run_forever,
                                        name="eval-cloud", daemon=True)
        self._thread.start()
        self._server = CloudServer(echo_features=True,
                                   tick=TickConfig(max_wait_s=0.0),
                                   backend=codec.backend)
        self._client = None
        try:
            asyncio.run_coroutine_threadsafe(
                self._server.start(), self._loop).result()
            self._client = SyncEdgeClient("127.0.0.1", self._server.port,
                                          codec=codec)
        except BaseException:
            self.close()
            raise

    def roundtrip(self, x: np.ndarray) -> tuple[np.ndarray, int]:
        res = self._client.submit(x)
        # a copy: the received array is a read-only view of the frame
        return np.array(res.arrays[0]), res.coded_bytes

    def close(self) -> None:
        """Close the client, the server and the loop, in that order."""
        import asyncio

        try:
            if self._client is not None:
                self._client.close()
        finally:
            asyncio.run_coroutine_threadsafe(
                self._server.close(), self._loop).result()
            self._loop.call_soon_threadsafe(self._loop.stop)
            self._thread.join(timeout=10)
            self._loop.close()


def _sweep(sc: Scenario, cfg, params, ev_tokens: np.ndarray,
           cal_tokens: np.ndarray, split_after: int, backend: str | None,
           device) -> tuple[list[CaseResult], int]:
    """The rungs x clip-modes sweep of one scenario on ``cfg`` and
    ``params`` (on ``device``) at boundary ``split_after``.  Returns
    (cases, predictions scored per case)."""

    def head(tokens):
        x = models.forward_head(cfg, params,
                                torch.as_tensor(tokens, device=device),
                                split_after=split_after)
        return x.to(torch.float32).cpu().numpy()

    def tail(x):
        logits = models.forward_from_boundary(
            cfg, params, torch.as_tensor(x, device=device),
            split_after=split_after)
        return np.asarray(logits.cpu(), np.float64)

    with torch.inference_mode():
        boundaries = [head(t) for t in ev_tokens]
        cal_boundary = head(cal_tokens)
        ref_logits = [tail(b) for b in boundaries]
    ref_top1 = [np.argmax(rl, axis=-1) for rl in ref_logits]
    # decisive mask: reference top-2 logit margin above the scenario
    # threshold -- near-tie argmax is chance, not task signal
    top2 = [np.partition(rl, -2, axis=-1)[..., -2:] for rl in ref_logits]
    decisive = [(t[..., 1] - t[..., 0]) > sc.decisive_margin for t in top2]
    n_tokens = int(sum(t.size for t in ref_top1))
    n_decisive = int(sum(d.sum() for d in decisive))
    if n_decisive == 0:
        raise ValueError(
            f"{sc.name}: no decisive tokens at margin "
            f"{sc.decisive_margin} -- widen the eval batches or lower "
            "decisive_margin")

    cases = []
    for clip_mode in sc.clip_modes:
        for rung in sc.rungs:
            codec = calibrate(
                codec_config_for(sc, rung, clip_mode, backend=backend),
                cal_boundary)
            link = (_LoopbackLink(codec) if sc.transport == "loopback"
                    else None)
            agree_dec = 0
            agree_all = 0
            sq = 0.0
            coded = 0
            elems = 0
            try:
                for b, rt, rl, dm in zip(boundaries, ref_top1, ref_logits,
                                         decisive):
                    if link is not None:
                        recon, nbytes = link.roundtrip(b)
                    else:
                        recon, nbytes = _roundtrip_inproc(codec, b)
                    with torch.inference_mode():
                        logits = tail(recon.reshape(b.shape))
                    same = np.argmax(logits, axis=-1) == rt
                    agree_dec += int(same[dm].sum())
                    agree_all += int(same.sum())
                    sq += float(((logits - rl) ** 2).sum())
                    coded += nbytes
                    elems += b.size
            finally:
                if link is not None:
                    link.close()
            agreement = agree_dec / n_decisive
            raw_agreement = agree_all / n_tokens
            cases.append(CaseResult(
                scenario=sc.name, rung=rung, clip_mode=clip_mode,
                bits_per_elem=coded * 8.0 / elems,
                degradation=1.0 - agreement, agreement=agreement,
                raw_degradation=1.0 - raw_agreement,
                raw_agreement=raw_agreement, n_decisive=n_decisive,
                logit_rmse=(sq / sum(r.size for r in ref_logits)) ** 0.5,
                coded_bytes=coded, n_elems=elems))
    return cases, n_tokens


def _default_tap(cfg) -> int:
    """The config's default boundary: a quarter of its full periods."""
    return min(max(1, cfg.n_full_periods // 4), cfg.n_full_periods - 1)


def run_scenario(sc: Scenario, *, split_after: int | None = None,
                 backend: str | None = None,
                 device="cuda") -> ScenarioReport:
    """Sweep one scenario's rungs x clip-modes matrix.

    ``split_after`` overrides the scenario's boundary (the split-point
    selector drives this); ``backend`` is the codec's quantizer backend
    (None: the CUDA kernels; "torch": the torch formulas on the CPU);
    ``device`` is where the model runs.
    """
    t0 = time.perf_counter()
    device = models.resolve_device(device)
    cfg = sc.model_config()
    sa = split_after if split_after is not None else sc.split_after
    # resolve the default so the report names the evaluated boundary
    if sa is None:
        sa = _default_tap(cfg)
    gen = torch.Generator(device=device).manual_seed(sc.seed)
    params = models.init_params(cfg, gen, device=device)
    ev_tokens, cal_tokens = _token_batches(sc, cfg.vocab_size)
    cases, n_tokens = _sweep(sc, cfg, params, ev_tokens, cal_tokens, sa,
                             backend, device)
    return ScenarioReport(scenario=sc, cases=tuple(cases), split_after=sa,
                          n_tokens=n_tokens,
                          elapsed_s=time.perf_counter() - t0)


def run_matrix(scenarios, *, backend: str | None = None, device="cuda"
               ) -> dict[str, ScenarioReport]:
    """Run a list of scenarios; returns name -> report (insertion order)."""
    out: dict[str, ScenarioReport] = {}
    for sc in scenarios:
        out[sc.name] = run_scenario(sc, backend=backend, device=device)
    return out

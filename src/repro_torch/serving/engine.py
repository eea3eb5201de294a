"""Batched serving engine: continuous batched decode with the paper's
feature codec applied at the split layer.

Slots hold independent requests; each engine step decodes one token for
every active slot.  Finished slots are *refilled from the queue
mid-flight*: a freed slot gets the next queued request prefilled
(batch-1, left-padded to the batch's current absolute length so its
cache positions line up with the shared position counter) and copied
into the batched cache in place, so short requests free capacity instead
of holding the batch until the longest request finishes.  When every
slot is idle the engine starts a fresh epoch with a full-batch prefill
(which also admits prompts longer than the current position).

The codec path reports bits/element of the split-layer transfer per step,
and per-request wall-clock latency lands in ``latency_log``.
"""

from __future__ import annotations

import collections
import dataclasses
import logging
import time

import numpy as np
import torch
import torch.distributed as dist

from ..configs.base import ModelConfig
from ..core.codec import FeatureCodec
from ..models import (build_groups, decode_step, init_cache, prefill,
                      resolve_device)
from ..models.context import dp_rows, gather_rows
from ..models.transformer import _need_boundary
from ..obs.metrics import BPE_BUCKETS, MetricsRegistry
from ..obs.tracing import span

log = logging.getLogger(__name__)


@dataclasses.dataclass
class Request:
    prompt: np.ndarray          # (S,) int32
    max_new_tokens: int = 16
    out_tokens: list = dataclasses.field(default_factory=list)
    done: bool = False
    t_admit: float | None = None
    t_done: float | None = None

    @property
    def latency_s(self) -> float | None:
        if self.t_admit is None or self.t_done is None:
            return None
        return self.t_done - self.t_admit


class ServeEngine:
    def __init__(self, cfg: ModelConfig, params, *, slots: int = 4,
                 max_seq: int = 256, ctx=None, codec_fn=None,
                 codec: FeatureCodec | None = None, codec_host_fn=None,
                 refill_align: int = 1,
                 metrics: MetricsRegistry | None = None,
                 latency_log_size: int = 4096, device="cuda"):
        """``codec`` is the preferred split-layer hookup: a calibrated
        :class:`FeatureCodec` whose fused fake-quant + rate estimate is
        applied at the boundary.  The raw ``codec_fn`` callable
        ``x -> (x', rate_bits)`` remains for custom transforms.

        ``codec_host_fn`` is the *host round-trip* variant for codecs
        that leave the device (bitstream encode/decode, transports): a
        plain ``numpy (B, S, d) -> (numpy recon, rate_bits)`` callable,
        which the engine calls as its split-layer hook
        (:func:`_host_hook`); the model must have a split boundary.

        ``refill_align``: admit mid-epoch refills only at positions that
        are multiples of this (freed slots idle up to
        ``refill_align - 1`` steps).

        ``metrics``: a :class:`MetricsRegistry` to register this engine's
        instruments in (fresh per engine by default).
        ``latency_log_size`` bounds the per-request ``latency_log`` ring
        buffer.

        ``device``: where the model runs (``params`` must live there);
        the default CUDA device raises where none exists.

        ``ctx``: a ``DistContext`` passed to every prefill and decode, as
        the reference does: each rank runs the engine on the same
        requests, its MoE layers expert-parallel over the tp ranks
        (``params`` holding this rank's experts).  Where the dp ranks
        divide ``slots``, each rank runs the full-batch prefills and the
        decode steps on its block of the slots (``dp_rows``), holds only
        its block's caches, and all-gathers the logits over the dp group
        before sampling, so every rank samples the whole batch and keeps
        the same slot state.  A refill (batch 1) is computed whole on
        every dp rank, and only the rank whose block holds the slot keeps
        its caches; every step where dp does not divide ``slots`` runs
        whole on every rank too.  The rate is
        the whole batch's: a ``codec`` sums its index counts over the dp
        group before the rate is taken; a codec whose tiles span rows, a
        ``codec_fn`` and a ``codec_host_fn`` get the whole boundary,
        gathered, and each rank keeps its rows of what they return."""
        self.cfg, self.params, self.ctx = cfg, params, ctx
        self.device = resolve_device(device)
        if sum(x is not None for x in (codec, codec_fn, codec_host_fn)) > 1:
            raise ValueError("pass at most one of codec, codec_fn, "
                             "codec_host_fn")
        # split the slots over the dp ranks (a block of rows each)
        self._split = ctx is not None and ctx.dp_size > 1 \
            and slots % ctx.dp_size == 0
        if codec is not None:
            codec_fn = codec.apply_with_rate
        if codec_host_fn is not None:
            _need_boundary(cfg, build_groups(cfg, True)[1])
            codec_fn = _host_hook(codec_host_fn)
        self.codec_fn = codec_fn
        # the split-layer hook of a step on the whole batch (False) and of
        # one on this rank's block of rows (True); ``_run`` picks
        self._hooks = {False: codec_fn,
                       True: self._block_hook(codec) if self._split
                       else None}
        self.slots = slots
        self.max_seq = max_seq
        self.refill_align = max(1, refill_align)
        self.rate_log: collections.deque = collections.deque(maxlen=1 << 16)
        self.latency_log: collections.deque = collections.deque(
            maxlen=max(1, latency_log_size))
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        m = self.metrics
        self._m = {
            "steps": m.counter("repro_engine_steps_total",
                               "batched decode steps"),
            "slot_steps": m.counter("repro_engine_slot_steps_total",
                                    "slots * decode steps"),
            "active_slot_steps": m.counter(
                "repro_engine_active_slot_steps_total",
                "decode steps weighted by occupied slots"),
            "prefills": m.counter("repro_engine_prefills_total",
                                  "prefill launches (epochs + refills)"),
            "refills": m.counter("repro_engine_refills_total",
                                 "mid-epoch slot refills"),
            "epochs": m.counter("repro_engine_epochs_total",
                                "full-batch prefill epochs"),
        }
        self._m_requests = m.counter("repro_engine_requests_total",
                                     "requests retired")
        self._m_latency = m.histogram(
            "repro_engine_request_latency_seconds",
            "request wall-clock latency (admit -> retire)")
        self._m_bpe = m.histogram(
            "repro_engine_split_rate_bpe",
            "split-layer coded bits/element per decode step",
            buckets=BPE_BUCKETS)
        self._prefill = lambda p, t, c, *, split: prefill(
            cfg, p, t, c, ctx=ctx, codec_fn=self._hooks[split])
        self._decode = lambda p, t, c, pos, *, split: decode_step(
            cfg, p, t, c, pos, ctx=ctx, codec_fn=self._hooks[split])

    # -- the dp split ---------------------------------------------------------

    def _run(self, fn, toks: torch.Tensor, cache, *args):
        """``fn(params, toks, cache, *args, split=)`` (``_prefill`` or
        ``_decode``) on this rank's block of ``toks``'s rows where the
        batch is split over dp (``split=True``), else on all of them; the
        logits (the output's first item) of the whole batch either way."""
        split = self._split and toks.shape[0] == self.slots
        out = fn(self.params, dp_rows(toks, self.ctx) if split else toks,
                 cache, *args, split=split)
        if not split:
            return out
        return (gather_rows(out[0], self.ctx),) + tuple(out[1:])

    def _block_hook(self, codec: FeatureCodec | None):
        """``codec_fn`` for a step on this rank's block of rows: the
        whole batch's rate, and this block's reconstruction (None where
        there is no ``codec_fn``)."""
        fn, ctx = self.codec_fn, self.ctx
        if fn is None:
            return None
        if codec is not None and not codec.tiles_span_rows():
            def counted(x):
                _, deq, counts = codec.quantize_with_counts(x, want_deq=True)
                dist.all_reduce(counts, group=ctx.dp_group)
                whole = (x.shape[0] * ctx.dp_size,) + tuple(x.shape[1:])
                return deq, codec.rate_from_counts(counts, whole)
            return counted

        def gathered(x):
            y, rate = fn(gather_rows(x, ctx))
            return dp_rows(y, ctx), rate
        return gathered

    # -- scheduling -----------------------------------------------------------

    @torch.inference_mode()
    def generate(self, requests: list[Request], greedy: bool = True):
        """Run all requests to completion (continuous batching with slot
        refill)."""
        for r in requests:
            if len(r.prompt) + r.max_new_tokens > self.max_seq:
                raise ValueError(
                    f"request needs {len(r.prompt) + r.max_new_tokens} "
                    f"cache positions, engine has max_seq={self.max_seq}")
        queue = list(requests)
        active: list[Request | None] = [None] * self.slots
        cache = None
        cur = None          # (slots,) next token per slot, on the host
        pos = 0             # shared absolute position of the next decode

        while queue or any(r is not None for r in active):
            if all(r is None for r in active):
                cache, cur, pos = self._start_epoch(queue, active)
                continue
            # one decode step for every slot (finished/empty slots ride
            # along; their logits are ignored)
            for i, r in enumerate(active):
                if r is None:
                    continue
                if len(r.out_tokens) < r.max_new_tokens:
                    r.out_tokens.append(int(cur[i]))
                if len(r.out_tokens) >= r.max_new_tokens:
                    self._retire(active, i)
            if all(r is None for r in active) and not queue:
                break
            if pos % self.refill_align == 0:
                for i in range(self.slots):
                    if active[i] is None and queue:
                        cache, cur = self._refill(queue, active, i, cache,
                                                  cur, pos)
            if all(r is None for r in active):
                continue    # nothing admitted (prompts too long for pos)
            n_active = sum(r is not None for r in active)
            self._m["steps"].inc()
            self._m["slot_steps"].inc(self.slots)
            self._m["active_slot_steps"].inc(n_active)
            # the span's syncs fall where the step waits anyway: after the
            # last step's tokens reached the host, and after this one's
            with span("decode", active=n_active, pos=pos):
                tok = torch.as_tensor(cur, device=self.device)
                lg, cache, aux = self._run(self._decode, tok, cache, pos)
                if "codec_rate_bits" in aux:
                    bpe = float(aux["codec_rate_bits"])
                    self.rate_log.append(bpe)
                    self._m_bpe.observe(bpe)
                cur = torch.argmax(lg, dim=-1).to(torch.int32).cpu().numpy()
            pos += 1
        return requests

    def _retire(self, active: list, i: int) -> None:
        r = active[i]
        r.done = True
        r.t_done = time.perf_counter()
        self.latency_log.append({
            "slot": i, "prompt_len": int(len(r.prompt)),
            "new_tokens": len(r.out_tokens), "latency_s": r.latency_s,
        })
        self._m_requests.inc()
        self._m_latency.observe(r.latency_s)
        log.info("request done: slot=%d prompt_len=%d tokens=%d "
                 "latency=%.3fs", i, len(r.prompt), len(r.out_tokens),
                 r.latency_s)
        active[i] = None

    def _admissible(self, r: Request, plen: int) -> bool:
        """Can ``r`` be prefilled at padded length ``plen``?"""
        return len(r.prompt) <= plen \
            and plen + r.max_new_tokens <= self.max_seq

    @property
    def counters(self) -> dict:
        """Structured serving metrics: slot occupancy of the continuous
        batch, admission churn, the split-layer rate actually spent and
        the requests retired.  The same numbers live as
        ``repro_engine_*`` instruments in :attr:`metrics`, beside the
        request-latency histogram."""
        t = {k: int(c.value()) for k, c in self._m.items()}
        return {
            **t,
            "batch_occupancy_avg": (t["active_slot_steps"]
                                    / max(t["slot_steps"], 1)),
            "split_bpe_avg": (float(np.mean(self.rate_log))
                              if self.rate_log else 0.0),
            "requests_done": int(self._m_requests.value()),
        }

    def _new_cache(self, batch: int):
        """Caches for ``batch`` rows: this rank's block of them where a
        batch of ``slots`` is split over dp."""
        if self._split and batch == self.slots:
            batch //= self.ctx.dp_size
        return init_cache(self.cfg, batch=batch, max_seq=self.max_seq,
                          split=self.codec_fn is not None,
                          device=self.device)

    def _start_epoch(self, queue: list, active: list):
        """Full-batch prefill of up to ``slots`` queued requests."""
        batch = [queue.pop(0) for _ in range(min(self.slots, len(queue)))]
        plen = max(len(r.prompt) for r in batch)
        toks = np.zeros((self.slots, plen), np.int32)
        t_admit = time.perf_counter()
        for i, r in enumerate(batch):
            toks[i, plen - len(r.prompt):] = r.prompt  # left-pad with 0
            r.t_admit = t_admit
            active[i] = r
        cache = self._new_cache(self.slots)
        self._m["epochs"].inc()
        self._m["prefills"].inc()
        with span("prefill", batch=len(batch), padded=self.slots * plen,
                  prompt=sum(len(r.prompt) for r in batch)):
            logits, cache = self._run(
                self._prefill, torch.as_tensor(toks, device=self.device),
                cache)
        cur = torch.argmax(logits, dim=-1).to(torch.int32).cpu().numpy()
        # zero-token requests retire immediately
        for i, r in enumerate(batch):
            if r.max_new_tokens <= 0:
                self._retire(active, i)
        return cache, cur, plen

    def _refill(self, queue: list, active: list, slot: int, cache, cur,
                pos: int):
        """Admit the next queued request into a freed slot mid-epoch.

        The prompt is left-padded to the batch's current absolute length
        ``pos`` and prefilled at batch size 1, then its cache is copied
        into row ``slot`` of every batched cache tensor (batch is axis 0
        of every leaf of a layer's cache, nested dicts included), so the
        shared position counter stays valid for every slot.  Requests whose prompt is longer than
        ``pos`` (or that would overflow ``max_seq``) wait for a fresh
        epoch.
        """
        k = next((j for j, r in enumerate(queue)
                  if self._admissible(r, pos)), None)
        if k is None:
            return cache, cur
        r = queue.pop(k)
        if r.max_new_tokens <= 0:
            r.t_admit = time.perf_counter()
            active[slot] = r
            self._retire(active, slot)
            return cache, cur
        toks = np.zeros((1, pos), np.int32)
        toks[0, pos - len(r.prompt):] = r.prompt
        with span("refill"):
            one = self._new_cache(1)
            r.t_admit = time.perf_counter()
            self._m["refills"].inc()
            self._m["prefills"].inc()
            with span("prefill", batch=1, refill=True, padded=pos,
                      prompt=len(r.prompt)):
                logits, one = self._run(
                    self._prefill, torch.as_tensor(toks, device=self.device),
                    one)
            # the slot's row of this rank's caches (none where another dp
            # rank holds it)
            n, row = self.slots, slot
            if self._split:
                n = self.slots // self.ctx.dp_size
                row = slot - self.ctx.dp_rank * n
            if 0 <= row < n:
                for full_g, one_g in zip(cache, one):
                    for full_l, one_l in zip(full_g, one_g):
                        _copy_row(full_l, one_l, row)
        first = int(torch.argmax(logits[0]))
        cur = cur.copy()
        cur[slot] = first
        active[slot] = r
        # this iteration's append phase already ran, so the refilled
        # request's first generated token is recorded here (it is fed to
        # the model at this iteration's decode); the next append phase
        # then records token two
        r.out_tokens.append(first)
        if len(r.out_tokens) >= r.max_new_tokens:
            self._retire(active, slot)
        return cache, cur


def _host_hook(codec_host_fn):
    """``codec_host_fn`` as a split-layer hook ``x -> (x', rate)``: the
    boundary goes to the host in float32, its reconstruction comes back
    to ``x``'s device in ``x``'s dtype, and the rate is rounded to
    float32, as the JAX engine's host round trip between its two jitted
    halves does."""
    def hook(x):
        recon, rate = codec_host_fn(x.to(torch.float32).cpu().numpy())
        recon = torch.as_tensor(np.asarray(recon, np.float32),
                                device=x.device)
        return recon.to(x.dtype), np.float32(rate)
    return hook


def _copy_row(full: dict, one: dict, slot: int) -> None:
    """Copy a batch-1 layer cache into row ``slot`` of the batched one,
    walking nested dicts (an RWKV layer's {"tmix": ..., "cmix": ...})."""
    for name, leaf in full.items():
        if isinstance(leaf, dict):
            _copy_row(leaf, one[name], slot)
        else:
            leaf[slot] = one[name][0]

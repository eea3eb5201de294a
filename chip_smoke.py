#!/usr/bin/env python3
"""Drive the PyTorch + CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure raises and exits non-zero:

1. device  -- the card's name and ``nvidia-smi`` name + power limit;
2. build   -- compile the hand-written CUDA kernels from ``src/repro_torch/
   csrc`` (timed);
3. kernels -- every kernel of the serving paths against its plain torch
   version on the card, at the paths' shapes (a (4, 64, 4096) prefill and
   a (4, 1, 4096) decode boundary, seeded; per-channel plans at g=8) and
   beyond (a 1-D tile plan with a short last block, a ragged 2-D plan;
   indices, packed bytes, histograms, ECSQ reconstructions and rANS blobs
   exact -- the prefill boundary's 16 rANS chunks coded in one launch
   give the blobs of 16 single-chunk launches; the per-tensor quantizer's
   histogram variants give the index histogram's bins, and its packing
   variant the pack kernel's bytes; the per-tile quantizer (#2) on its
   fast route (the g=8 boundaries) with and without its reconstruction,
   counting and packing, and on its element route (the other plans)
   without it, and the per-tile ECSQ quantizer (#8) likewise and in
   coded order; the per-tensor ECSQ quantizer (#7) with and without its
   reconstruction, counting and packing, from 1 to 4.8 million values;
   the tile histogram on each of its routes, one device operation a
   call; the histograms exact on two streams at once; uniform
   reconstructions within 1 ulp, #2's at 0), then each kernel
   timed at both sizes the serving paths launch it at (for the
   per-tensor quantizers (#1, #7) and the per-tile one also with their
   histogram, with and without the reconstruction, and packing; for #8
   also indices alone and in coded order; for #2's element route and
   the tile histogram also (m)'s 2-D plan; for the index histogram the
   whole wrapper call; for the per-tensor quantizer also phase 6's
   float32 index-only launches at N=256 and phase 8's (8, 256, 1152)
   training boundary with its histogram; for the encode megakernel also
   the transport tick's stacked launch of 16 decode boundaries, flat
   and on the g=8 plan; for the rANS step loop: one chunk, the 16-chunk
   batch, a decode tensor, and the tick's 16 per-session decode
   launches), beside the plain version's time and the bound (for
   the step loop, the larger of its byte bound and its dependent chain:
   the cycles of the step's least dependent chain, measured in this run
   by ``tools/rans_chain_probe.cu``, per step at the top SM clock
   ``nvidia-smi`` reports).  The decode-attention kernel (#10), bf16,
   against the plain decode path (the masked float32 attention over the
   whole cache, the slots past the prefix holding large values) within
   rtol 1.6e-2, atol 2e-3, at the benchmark cell's shape (48 rows x 8192
   slots, 32 / 4 heads of 128) at positions 0, 255, 8191 and 2150, at
   dbrx's stage (32 x 4096, 48 / 8 heads) at 0, 4095 and 2150, and at
   phase 4's decode shape; timed at the last position of each beside the
   plain path, its byte bound (the prefix of K and V read once) and
   ``F.scaled_dot_product_attention`` over the prefix.  The prefill
   attention kernel (#11), bf16, against the plain prefill path
   (``multi_head_attention(q, k, v, q_offset=0)``, float32 logits over
   the whole square) within rtol 1.6e-2, atol 1e-2, at a refill of the
   benchmark cell (1 row, 32 / 4 heads of 128) at lengths 1, 65, 512 and
   2150 and at phase 4's prefill shape (4 x 64, 32 / 32 heads); timed at
   the last length of each beside the plain path, its causal FLOP bound
   and ``F.scaled_dot_product_attention(is_causal=True)``;
4. serve   -- codeqwen1.5-7b at full width and depth (bf16, random
   weights from seed 0), 4 requests of 64 prompt + 8 new tokens, N=4,
   every codec calibrated from one set of warm-up activations:
   (a) per-tensor, the in-graph ``codec=`` hookup; (b) per-tensor, the
   host bitstream hookup ``decode_stream(encode_stream(x,
   chunk_elems=65536, device_entropy=True))``; (c) per-channel g=8,
   ``codec=``; (d) per-channel g=8, the bitstream hookup; (e) per-tensor
   ECSQ, ``codec=``; (f) per-channel ECSQ g=8, the bitstream hookup.
   Launch counts are reset before and read after each run -- also by
   size, prefill or decode -- and every kernel must have launched on its
   run, decode attention once a layer in each of the 7 decode steps of
   (a)-(f) and the 16 steps of (g)-(l) and (n); (a), (c) and (e) count their indices in the quantizer's launch
   and must launch no histogram, with each boundary's rate equal to the
   two-launch path's (quantize, then histogram); every boundary's
   payloads of (f), whose ECSQ quantizer writes coded order, equal the
   parent's route's (quantize, then permute); on the prefill boundary of
   (b), (d) and (f) the wire's indices must equal the quantizer
   kernel's.  (a) and (b) then run once more under ``torch.profiler``
   for the device's busy time and idle share;
5. split   -- the packed split runtime (``repro_torch.compression.
   split_runtime``) on the same model and weights, split 16 + 16 layers
   with both stages on this card: 4 sequences fed 8 prompt tokens one
   per decode step, then 8 greedy tokens (16 steps, ``max_seq`` 32), in
   seven runs -- (g) ``raw``; (h) ``packed`` per-tensor N=4; (i)
   ``quantized_f16`` with (h)'s codec; (j) ``packed`` N=2; (k)
   ``packed`` N=16; (l) ``packed`` per-channel g=8 N=4; (n) ``packed``
   per-tensor ECSQ N=4, designed as (e)'s -- every codec
   calibrated in "model" mode from the serve phase's warm-up batches at
   the split runtime's boundary.  (g) must equal the unsplit decode
   step's logits rounded through bfloat16, (h) and (i) must give
   identical logits; (h), (j), (k), (l) and (n) pack in the quantizer's
   launch, so the pack kernel must never launch in (g)-(l) and (n), and
   their payloads must be the bytes of the pack kernel's path
   (quantize, then pack); (h)-(l) and (n) launch no histogram and each
   step's rate equals the two-launch path's.  (h) then runs once more
   under ``torch.profiler``.  Then (m): the codec calls that still
   launch the standalone index histogram, tile histogram and pack --
   ``tile_rate_bits`` of a 2-D tile codec, ``pack`` of the per-channel
   ECSQ codec's indices, ``rate_from_indices`` of (e)'s codec --
   against their plain versions;
5b. transport -- the port's socket transport on the same weights and
   codecs: (q) the serve run of (b) through ``launch.serve.
   _loopback_codec_fn`` (a CloudServer on its own event-loop thread,
   (b)'s device entropy stage on the client): tokens equal to (b)'s,
   each boundary's wire rate above (b)'s payload rate, one server
   session a crossing, profiled as (b); (r) one async EdgeClient with
   16 concurrent sessions, each sending (b)'s 8 boundaries in order
   through the client's encode tick (``TickConfig(max_wait_s=0.002,
   max_batch=16, device_entropy=True)``) to a CloudServer on its
   default tick: payloads byte-identical to (b)'s, echoed
   reconstructions equal to ``decode_stream`` of them, one stacked
   encode launch a tick and one step-loop launch a session, counted
   exactly from the pool threads; (s) the same with the per-channel g=8
   codec on (d)'s boundaries; (t) ``launch.serve.main`` at the reduced
   size with ``--transport loopback --workers 2 --tick-ms 1``: no
   session shed;
6. eval    -- the accuracy harness (``repro_torch.eval``) on the default
   matrix's four scenarios, each a sweep of rungs 256, 16, 4 x clip
   modes minmax, empirical over 2 eval batches of 2 x 32 tokens with
   seed 0.  (o) At full width through ``harness._sweep``:
   ``transformer-tensor`` on codeqwen1.5-7b (the serve phase's
   weights, which are then freed), ``moe-expert`` on dbrx-132b cut to
   2 of its 40 layers (all 40 do not fit one card), ``rwkv-state`` on
   rwkv6-3b and ``rglru-state`` on recurrentgemma-2b, each split at the
   harness's default tap; on each boundary a CUDA-backend codec and a
   ``backend="torch"`` copy of it, per-tensor and per-channel g=8 at
   every rung, must give identical payloads and indices and
   reconstructions within 1 ulp.  (p) The registered smoke-size matrix
   through ``run_matrix(load_matrix("default"))``.  Launch counts are
   reset before and read after each sweep; the per-tensor quantizer and
   the encode megakernel must launch in each; every case's
   ``bits_per_elem`` must be ``coded_bytes * 8 / n_elems``, its logits
   finite, with decisive tokens.  ``transformer-loopback`` runs at full
   width on the serve weights beside its ``transport="inproc"`` twin:
   case by case the same degradation and more coded bytes on the
   socket;
7. launches -- (checked after phase 8) each run's launch counts
   against the kernels it must launch ((q), (r) and (s) the encode
   megakernel and the step loop, and no histogram or pack; (w) the
   per-tensor quantizer).  The device operations (``torch.profiler``)
   of one decode crossing of the (a), (c) and (e) hookups
   (``apply_with_rate``) and of the (h), (l) and (n) split steps'
   crossings are counted at the end of phase 3: their quantizer,
   histogram and pack stage must be one operation on each;
8. train   -- gemma3-1b at published width and full depth (26 layers,
   bf16, random weights from seed 0, the repo's token stream, batch 8 x
   256, AdamW defaults, warmup 2): (u) ``Trainer.run`` for 8 steps with
   one final async checkpoint -- loss finite and falling, step ms, the
   step split into forward + backward and AdamW, one step profiled, peak
   device memory, checkpoint size and write time, and its restore equal
   bit for bit to the state in memory; (v) 8 steps with 4-bit gradient
   compression and error feedback through the trainer's step method;
   (w) a per-tensor N=4 codec (calibrated in "model" mode from one
   forward's boundary) in the loop through ``make_train_step``, 4 steps:
   the per-tensor quantizer launches once a step and nothing else, the
   leaves before the boundary get zero gradients and exactly the
   decay-only update; (x) at the smoke size, a failure at step 5 after
   the step-4 checkpoint and a resume, the final parameters within
   rtol = atol = 1e-6 of the uninterrupted run's; (y) ``loss_fn`` and
   the gradients' global norm on the card (bf16) against the port's
   float32 CPU run of the same weights (1 x 128 tokens); (z) ``python -m
   repro_torch.launch.train --arch gemma3-1b --steps 4
   --grad-compress-bits 4`` in a subprocess.  Checkpoints go under
   ``build/train_phase`` (removed after the phase), which must have room
   for (u)'s ~14 GB;
9. dry run -- ``repro_torch.launch.dryrun.run_cell`` on the one-card
   mesh (``make_smoke_mesh(1)``, the ``meta`` device) for three steps
   the card runs above: gemma3-1b's train step at 8 x 256 (remat, one
   microbatch), codeqwen1.5-7b's prefill at (4, 64) and its decode at
   (4, 1) over the serve engine's cache of 80 positions; and rwkv6-3b's
   train step at 2 x 40 (published width, 4 of 32 layers), whose time
   loop the meta pass counts one step times the padded length of 48
   while the card runs all 48.  Each prints its model FLOPs, counted
   FLOPs, eager traffic and eager roofline (the record's
   ``step_time_lower_bound_s``: the larger of the FLOPs at the H100's
   peak and the eager traffic at its HBM rate); then the same step runs
   on the card (weights from seed 0).  Gates: ``FlopCounterMode``
   around it, plus the products of the decode- and prefill-attention
   launches it does not see, counts exactly the meta pass's FLOPs; the bytes of its
   arguments on the card equal the predicted ``memory.argument_bytes``;
   ``max_memory_allocated`` over the timed runs is within 10% of the
   predicted peak.  On the first three cells the first two gates hold
   by construction (shape-only FLOP formulas, no device branch; the
   one-card mesh shards nothing); the rwkv6 cell's FLOP gate and every
   peak gate can fail.  Its median time over 7 runs between syncs is
   printed against the eager roofline with the model-FLOPs share;
10. distributed -- the multi-device path (``repro_torch.models.context``).
   (aa) qwen3-moe-235b-a22b at published width (d_model 4096, 128
   experts, top-8, ``moe_d_ff`` 1536, capacity factor 1.25), bf16, cut
   to 2 of its 94 layers, random weights from seed 0, expert-parallel
   over two ranks spawned on this card in a (data, model) = (1, 2) mesh
   over gloo (NCCL refuses two ranks on one card; gloo stages the
   card's tensors through the host, so no collective time here is a
   link's), each rank keeping its 64 experts a layer.  Gates: on the
   prefill boundary (2, 64) each rank's chunk of the MoE layer's output
   equals ``moe_local`` of that chunk at the chunk's capacity, on the
   decode boundary (2, 1) the output equals ``moe_local`` at the rank's
   whole token count, both within 2^-5 of the largest output (bf16 FFNs
   at another batch shape; the decode path also sums in another order);
   ``ServeEngine(ctx=...)``'s logits on the prefill and 8 greedy decode
   steps identical in every bit on both ranks, tokens identical; one
   ``make_train_step(ctx=...)`` step at 2 x 64 on the model cut further
   to 32 experts and an 8,192-token vocabulary (AdamW's state for two
   ranks of the serving model does not fit the card): the loss identical
   on both ranks, every replicated leaf identical in every bit after
   it, the step's global norm within 1e-3 of the norm of the gradients
   gathered whole.  Printed: ms per EP layer on each boundary beside
   the one-rank layer's, each rank's peak memory beside the one-rank
   model's.  (ab) The packed split runtime at published width on that
   model (split 1 + 1) and on rwkv6-3b (all 32 layers, 16 + 16), 2
   sequences, 8 decode steps, a per-tensor N=4 codec calibrated in
   "model" mode: ``raw`` equal to the unsplit decode step rounded
   through bfloat16, ``packed`` launching the per-tensor quantizer once
   a step and never the pack kernel or a histogram.  (ag)
   ``ServeEngine(ctx=...)`` with its 4 slots split over a data axis of
   two gloo ranks on this card, codeqwen1.5-7b at published width cut
   to 2 of its 32 layers, 8 ragged requests (epochs and refills), a
   per-tensor N=4 ``codec=``: tokens, ``rate_log``, counters and
   retirements equal the one-rank engine's on both ranks; ms per decode
   step on each rank beside one rank's.  (ac) ``python -m
   torch.distributed.run --standalone --nproc_per_node 1 -m
   repro_torch.launch.train --distributed --arch gemma3-1b --steps 2
   --device cuda`` in a subprocess: NCCL, a world of one.
11. split across ranks -- the split runtime as processes of a (pod,
   data, model) mesh (``make_split_decode_step(..., ctx=...)``), each
   rank on this card over gloo, the crossing staged through host buffers
   (NCCL refuses two ranks on one card), each rank drawing the whole
   model from seed 0 and keeping its stage.  (ad) codeqwen1.5-7b at
   published width and depth, split 16 + 16, (2, 1, 1): ``raw`` on (g)'s
   tokens and ``packed`` with (h)'s codec on (h)'s, 4 sequences, 16
   steps; every rank's logits identical in every bit to (g)'s and (h)'s,
   the packed payload bytes and rates to (h)'s; the edge rank launches
   the per-tensor quantizer (packing in its launch) once a packed step
   and no other codec kernel (no pack, no histogram), the cloud rank no
   codec kernel.  (ae) qwen3-moe-235b-a22b at published width cut to 2 of its
   94 layers (1 + 1), (2, 1, 2), 64 experts a rank in each stage, the
   four ranks drawing in turn: ``packed`` with (ab)'s codec on (ab)'s
   tokens, 2 sequences, 8 steps; the two ``model`` ranks of each stage
   identical in every bit (payloads, logits), the logits within 2^-5 of
   the largest of (ab)'s one-process run's, the launches as in (ad).
   (af) codeqwen1.5-7b at published width cut to 2 + 2 layers, (2, 2,
   1), four ranks: ``packed`` with a tiled codec whose tiles span rows
   (N=4, 8 channels x 2 rows a tile, calibrated by min/max on the first
   step's boundary), 4 sequences, 16 steps; the edge ranks gather their
   rows and quantize the whole batch's tiles: every rank's logits and
   rates and both edge ranks' payloads identical in every bit to the
   one-process runtime's on the same weights, codec and tokens, each
   edge rank launching the codec kernels the one-process run launched,
   each cloud rank none.  In (ad), (ae) and (af) every rank also launches
   decode attention once an attention layer of its stage a step.
   Printed: ms per step (median) split into edge stage, crossing (the
   edge's stage done until the cloud holds the payload on the card, host
   staging included), cloud stage and return path, from the step's
   tracing spans (a device sync at each span's ends, then the host
   clock, which the processes share), beside (h)'s one-process ms per
   step; link bytes per step each way; peak device memory per rank.
12. examples -- the four examples (``repro_torch.examples``) as
   subprocesses at the reference scripts' settings, six runs at once:
   ``quickstart`` (its lines equal its ``--device cpu`` run's),
   ``split_inference`` (its table of 8 rows; the per-tensor and the
   per-tile quantizer launch), ``train_with_compression`` (the resumed
   run's losses equal the uninterrupted run's, bit for bit), and
   ``edge_cloud_demo --smoke`` and ``--smoke --tls --secret s3kr1t``
   (the OK line); each exits 0.  (ah) the demo's ``run_cloud`` and
   ``run_edge`` as two processes on this card, codeqwen1.5-7b at
   published width cut to 4 layers, batch 4 x seq 32, 3 sessions, N=8
   per channel group of 8: the demo's own checks (reconstruction
   bit-exact with the in-process round trip, tail logits within rtol =
   atol = 1e-4), and the edge's stream encode launches the encode
   megakernel and the device rANS step loop.  Printed: bits/element per
   session, the sessions' wall time, each process's launches.

The line before the last is the per-kernel JSON record (each kernel's
numbers per size under ``sizes``, with its launches per run at that
size, its launches in phase 6 under ``eval_launches``, in (w) under
``train_launches``, on each rank of phase 11's runs under
``split_ranks_launches``, on each rank of (ag) under
``dp_engine_launches``, in each process of phase 12 that counts them
under ``example_launches``, and its port status); the last line is
``{"ok": true, "device": {...}}``.  Without a CUDA device, or outside a
checkout of the repository, it exits non-zero and prints no result.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

MEM_BYTES_PER_S = 3.35e12     # H100 SXM HBM3 (NVIDIA data sheet)
FP32_OPS_PER_S = 67e12        # H100 SXM CUDA-core float32 peak
BF16_MMA_OPS_PER_S = 989e12   # H100 SXM dense bf16 tensor-core peak
# one-thread latency probe of a rANS step (kernel #6), for its chain bound
PROBE = ROOT / "tools" / "rans_chain_probe.cu"
PROBE_ITERS = 4096
LEVELS = (2, 3, 4, 8, 16, 64)
N_SERVE = 4
GROUP = 8                   # channels per range (the transformer-channel cell)
CHUNK = 1 << 16
REQUESTS, PROMPT_LEN, NEW_TOKENS = 4, 64, 8
WARMUP_BATCHES = 2          # calibration batches of split-layer activations
ECSQ_LAGRANGIAN = 0.05
SPLIT_PROMPT, SPLIT_NEW, SPLIT_MAX_SEQ = 8, 8, 32
# decode attention (#10), bf16, 128 a head: name -> (rows, cache slots,
# query heads, KV heads, positions checked against the plain path, the
# last also timed) -- the benchmark cell's shape, dbrx's stage, and the
# shape phase 4's decode steps launch it at (its last step)
DA_SHAPES = {"cell": (48, 8192, 32, 4, (0, 255, 8191, 2150)),
             "dbrx": (32, 4096, 48, 8, (0, 4095, 2150)),
             "decode": (REQUESTS, PROMPT_LEN + NEW_TOKENS + 8, 32, 32, (70,))}
DA_TOL = dict(rtol=1.6e-2, atol=2e-3)   # bf16 outputs against the plain path
# prefill attention (#11), bf16, 128 a head: name -> (rows, query heads,
# KV heads, lengths checked against the plain path, the last also timed)
# -- a refill of the benchmark cell, and phase 4's opening prefill
PA_SHAPES = {"refill": (1, 32, 4, (1, 65, 512, 2150)),
             "prefill": (REQUESTS, 32, 32, (PROMPT_LEN,))}
PA_TOL = dict(rtol=1.6e-2, atol=1e-2)   # as tests/test_torch_cuda.py holds #11
PERF = ROOT / "PERF.md"    # its kernel table: each kernel's status
TICK_SESSIONS = 16      # concurrent sessions of the transport runs (r), (s)
# run -> (transport, split codec); the codecs are built in split_phase
SPLIT_RUNS = {"g": ("raw", None), "h": ("packed", "tensor-4"),
              "i": ("quantized_f16", "tensor-4"), "j": ("packed", "tensor-2"),
              "k": ("packed", "tensor-16"), "l": ("packed", "channel-4"),
              "n": ("packed", "ecsq-4")}


def bits_for(n_levels: int) -> int:
    return max(1, (n_levels - 1).bit_length())


def time_ms(fn, reps: int = 20, trials: int = 5) -> float:
    """Device time of one call of ``fn``, python dispatch excluded: the
    stream is first held by a spin kernel (``torch.cuda._sleep``) that
    outlasts the host's enqueueing of ``reps`` calls, so the two CUDA
    events bracket the calls' kernels running back to back.  Returns the
    median over ``trials`` of the per-call time."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    spin = int(min(2.0, 3 * host_s + 1e-3) * 2e9)     # cycles at ~2 GHz
    out = []
    for _ in range(trials):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(spin)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        torch.cuda.synchronize()
        out.append(a.elapsed_time(b) / reps)
    return statistics.median(out)


def eager_ms(fn, reps: int = 20) -> float:
    """Wall time per call dispatched eagerly from python (what a caller
    that does not capture graphs sees), with CUDA events."""
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def bound(n_bytes: float, n_ops: float,
          ops_per_s: float = FP32_OPS_PER_S) -> tuple[float, str]:
    """Least time for the work: bytes over the memory rate vs operations
    over ``ops_per_s``, the CUDA-core rate unless the work runs on the
    tensor cores (ms, and which one binds)."""
    t_mem = n_bytes / MEM_BYTES_PER_S * 1e3
    t_ops = n_ops / ops_per_s * 1e3
    return (t_mem, "bytes") if t_mem >= t_ops else (t_ops, "operations")


def ulps(a, b) -> int:
    """Largest distance between two same-dtype tensors in units of the
    last place of that dtype (at the larger magnitude)."""
    p = 7 if a.dtype == torch.bfloat16 else 23      # mantissa bits
    a32, b32 = a.float(), b.float()
    _, e = torch.frexp(torch.maximum(a32.abs(), b32.abs()))
    sp = torch.ldexp(torch.ones_like(a32), e - 1 - p)
    return int(((a32 - b32).abs() / sp).max().item())


def synthetic_boundary(dev):
    """Seeded stand-ins for the serving path's boundary tensors: the
    (4, 64, 4096) prefill and (4, 1, 4096) decode activations in bf16,
    with a clip range like the calibrated one."""
    gen = torch.Generator(device=dev).manual_seed(0)
    pre = torch.randn(4, 64, 4096, device=dev, generator=gen) * 1.3 + 0.1
    dec = torch.randn(4, 1, 4096, device=dev, generator=gen) * 1.3 + 0.1
    # the transport tick's stacked launch: TICK_SESSIONS decode
    # boundaries, one per session, stacked on a new leading axis
    tick = torch.randn(TICK_SESSIONS, 4, 4096, device=dev,
                       generator=gen) * 1.3 + 0.1
    return {"prefill": pre.to(torch.bfloat16),
            "decode": dec.to(torch.bfloat16),
            "tick": tick.to(torch.bfloat16), "range": (-2.2, 2.9)}


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


# -- phase 3: kernels against their plain versions ------------------------------

def channel_plan(d_model: int):
    """The serving codec's per-channel plan: one range per GROUP channels
    of the (B, T, d_model) boundary."""
    from repro_torch.core.tiling import TilePlan
    return TilePlan(channel_axis=-1, channel_group_size=GROUP,
                    spatial_block_size=0, n_channels=d_model)


def tiled_cases(boundary, dev):
    """(name, x, plan) cases of the tiled kernels: the serving boundaries
    under the g=8 channel plan, a 1-D tile plan with a short last block
    (256 positions in blocks of 100), and a ragged 2-D plan on an NCHW
    map (channels not innermost)."""
    from repro_torch.core.tiling import TilePlan, spatial_grid
    gen = torch.Generator(device=dev).manual_seed(2)
    pre = boundary["prefill"]
    d_model = pre.shape[-1]
    tile = TilePlan(channel_axis=-1, channel_group_size=GROUP,
                    spatial_block_size=100, n_channels=d_model,
                    spatial_extent=pre.numel() // d_model)
    conv = torch.randn(2, 32, 28, 28, device=dev, generator=gen) * 1.3 + 0.1
    grid = spatial_grid(tuple(conv.shape), 1)
    tile2d = TilePlan(channel_axis=1, channel_group_size=3,
                      spatial_block_size=0, n_channels=32,
                      spatial_extent=grid[0] * grid[1], spatial_hw=grid,
                      spatial_block_hw=(5, 6))
    return [("prefill", pre, channel_plan(d_model)),
            ("decode", boundary["decode"], channel_plan(d_model)),
            ("tile-short-last", pre, tile),
            ("2d-ragged", conv.to(torch.bfloat16), tile2d)]


def tile_ranges(plan, lo: float, hi: float, dev, seed: int):
    """Per-tile float32 (lo, hi) tables around the boundary's range, one
    tile degenerate (lo == hi)."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    shape = (plan.n_cgroups, plan.n_sblocks)
    t_lo = lo + torch.rand(shape, device=dev, generator=gen) * 0.8 - 0.4
    t_hi = hi + torch.rand(shape, device=dev, generator=gen) * 0.8 - 0.4
    t_hi.view(-1)[plan.n_tiles // 2] = t_lo.view(-1)[plan.n_tiles // 2]
    return t_lo, t_hi


def ecsq_tables(lo: torch.Tensor, hi: torch.Tensor, n_levels: int, dev,
                seed: int):
    """Ascending float32 thresholds (..., N-1) and levels (..., N) in each
    [lo, hi] (levels pinned to the ends, thresholds at midpoints)."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    u = torch.sort(torch.rand(tuple(lo.shape) + (n_levels - 2,), device=dev,
                              generator=gen), -1).values
    lo, hi = lo[..., None], hi[..., None]
    levels = torch.cat([lo, lo + (hi - lo) * u, hi], -1)
    return ((levels[..., 1:] + levels[..., :-1]) / 2).contiguous(), \
        levels.contiguous()


def tiled_checks(boundary, dev):
    """Exactness sweep of kernels #2, #5 and #8 against their plain
    versions, and of the megakernel's plan route against its CPU plain
    version: #2 on its fast route (the g=8 boundaries) with and without
    the reconstruction, with the per-tile counts and packing them at
    every width that holds N, and on its element route (the other plans)
    with and without the reconstruction; #8 likewise, and on its fast
    route in coded order.  Returns #2's worst reconstruction distance in
    ulps (each is checked to be 0)."""
    from repro_torch.kernels import ecsq_assign as ea
    from repro_torch.kernels import fused_clip_quant as fcq
    from repro_torch.kernels import ops, rate_hist

    lo, hi = boundary["range"]
    worst = 0
    for name, x0, plan in tiled_cases(boundary, dev):
        maps = fcq.tile_maps(plan, x0.shape, dev)
        fast = fcq.fast_route(maps)
        check(fast == (name in ("prefill", "decode")),
              f"{name}: fast route {fast}")
        t_lo, t_hi = tile_ranges(plan, lo, hi, dev, seed=3)
        for dtype in (torch.bfloat16, torch.float32):
            x = x0.to(dtype)
            for n in LEVELS:
                what = f"{name} {dtype} N={n}"
                ki, kd = fcq.clip_quant_tiles(x, t_lo, t_hi, n, plan)
                pi, pd, ph = fcq.clip_quant_tiles_plain(
                    x, t_lo, t_hi, n, maps, want_hist=True)
                check(torch.equal(ki, pi), f"clip_quant_tiles idx {what}")
                u = ulps(kd, pd)
                check(u == 0, f"clip_quant_tiles deq {what}: {u} ulp")
                worst = max(worst, u)
                gi, gd = fcq.clip_quant_tiles(x, t_lo, t_hi, n, plan,
                                              want_deq=False)
                check(gd is None and torch.equal(gi, pi),
                      f"clip_quant_tiles idx only {what}")
                if fast:
                    for kw in (dict(), dict(want_deq=False)):
                        out = fcq.clip_quant_tiles(x, t_lo, t_hi, n, plan,
                                                   want_hist=True, **kw)
                        check(torch.equal(out[0], pi)
                              and (out[1] is None or torch.equal(out[1], pd))
                              and torch.equal(out[2], ph),
                              f"clip_quant_tiles +hist {kw} {what}")
                    for bits in (1, 2, 4):
                        if n <= 1 << bits:
                            kp, kh = fcq.clip_quant_tiles_pack(
                                x, t_lo, t_hi, n, plan, bits)
                            pp, pph = fcq.clip_quant_tiles_pack_plain(
                                x, t_lo, t_hi, n, maps, bits)
                            check(torch.equal(kp, pp) and torch.equal(kh, pph),
                                  f"clip_quant_tiles +pack {bits} {what}")
                check(torch.equal(
                    rate_hist.index_histogram_tiles(ki, n, plan), ph),
                    f"index_histogram_tiles {what}")
                thr, lvl = ecsq_tables(t_lo, t_hi, n, dev, seed=n)
                ki, kd = ea.ecsq_assign_tiles(x, t_lo, t_hi, thr, lvl, plan)
                pi, pd = ea.ecsq_assign_tiles_plain(x, t_lo, t_hi, thr, lvl,
                                                    maps)
                check(torch.equal(ki, pi) and torch.equal(kd, pd),
                      f"ecsq_assign_tiles {what}")
                gi, gd = ea.ecsq_assign_tiles(x, t_lo, t_hi, thr, lvl, plan,
                                              want_deq=False)
                check(gd is None and torch.equal(gi, pi),
                      f"ecsq_assign_tiles idx only {what}")
                if fast:
                    check(torch.equal(
                        ea.ecsq_assign_tiles_coded(x, t_lo, t_hi, thr, lvl,
                                                   plan),
                        ea.ecsq_assign_tiles_coded_plain(x, t_lo, t_hi, thr,
                                                         lvl, maps)),
                        f"ecsq_assign_tiles coded {what}")
        for n in (2, 4, 16, 64):
            bits = bits_for(n)
            xf = x0.float()
            kp, kh, _ = ops.encode_fused(xf, t_lo, t_hi, n_levels=n,
                                         bits=bits, plan=plan)
            pp, ph, _ = ops.encode_fused(xf.cpu(), t_lo.cpu(), t_hi.cpu(),
                                         n_levels=n, bits=bits, plan=plan)
            check(torch.equal(kp.cpu(), pp) and torch.equal(kh.cpu(), ph),
                  f"encode_tiles plan route {name} N={n}")
    return worst


def kernel_checks(boundary, dev):
    """Exactness sweep of all four kernels against their plain versions;
    returns the worst reconstruction distance in ulps."""
    from repro_torch.core import binarization, cabac, rans
    from repro_torch.kernels import fused_clip_quant as fcq
    from repro_torch.kernels import ops, rans_coder, rate_hist

    gen = torch.Generator(device=dev).manual_seed(1)
    flat_cases = {
        "prefill": boundary["prefill"],                       # (4, 64, 4096)
        "decode": boundary["decode"],                         # (4, 1, 4096)
        "n513": torch.randn(513, device=dev, generator=gen) * 2 + 0.5,
    }
    lo, hi = boundary["range"]
    worst_deq = 0
    for name, x0 in flat_cases.items():
        for dtype in (torch.bfloat16, torch.float32):
            x = x0.to(dtype)
            for n in LEVELS:
                ki, kd = fcq.clip_quant_2d(x, lo, hi, n)
                pi, pd = fcq.clip_quant_plain(x, lo, hi, n)
                check(torch.equal(ki, pi), f"clip_quant idx {name} {dtype} N={n}")
                u = ulps(kd, pd)
                check(u <= 1, f"clip_quant deq {name} {dtype} N={n}: {u} ulp")
                worst_deq = max(worst_deq, u)
                kh = rate_hist.index_histogram_2d(ki, n)
                ph = rate_hist.index_histogram_plain(ki, n)
                check(torch.equal(kh, ph), f"index_histogram {name} N={n}")
                # the quantizer's own counts, with and without deq
                fi, fd, fh = fcq.clip_quant_2d(x, lo, hi, n, want_hist=True)
                gi, gd, gh = fcq.clip_quant_2d(x, lo, hi, n, want_deq=False,
                                               want_hist=True)
                check(torch.equal(fi, pi) and torch.equal(fd, kd)
                      and torch.equal(fh, ph) and gd is None
                      and torch.equal(gi, pi) and torch.equal(gh, ph),
                      f"clip_quant +hist {name} {dtype} N={n}")
                wild = (ki.reshape(-1)[:4099] * 7 - 5).contiguous()
                check(torch.equal(
                    ops.index_histogram(wild, n_levels=n),
                    rate_hist.index_histogram_plain(wild, n)),
                    f"index_histogram out of range {name} N={n}")
                check(torch.equal(ops.index_histogram(ki, n_levels=n),
                                  torch.bincount(ki.reshape(-1).long(),
                                                 minlength=n).int()),
                      f"index_histogram vs bincount {name} N={n}")
                bits = bits_for(n)
                x2d, _ = ops._to_2d(x.reshape(-1), lo)
                r, c = x2d.shape
                lo_r = torch.full((r, 1), float(lo), device=dev)
                hi_r = torch.full((r, 1), float(hi), device=dev)
                valid = fcq.band_valid_array(1, c, None, device=dev)
                kp, kh2 = fcq.encode_tiles_2d(x2d, lo_r, hi_r, n, bits,
                                              sb_cols=c, bs=c)
                pp, ph2 = fcq.encode_tiles_plain(x2d, lo_r, hi_r, valid, n,
                                                 bits, c)
                check(torch.equal(kp, pp) and torch.equal(kh2, ph2),
                      f"encode_tiles {name} {dtype} N={n}")
    # banded megakernel: 3 bands, ragged valid counts, per-(row, band)
    # ranges including a degenerate band
    xb = torch.randn(40, 3 * 512, device=dev, generator=gen) * 3
    lob = torch.rand(40, 3, device=dev, generator=gen) * -3
    hib = lob + torch.rand(40, 3, device=dev, generator=gen) * 4 + 0.5
    hib[3, 1] = lob[3, 1]
    for n in LEVELS:
        bits = bits_for(n)
        valid = (512, 300, 17)
        kp, kh = fcq.encode_tiles_2d(xb, lob, hib, n, bits, sb_cols=512,
                                     bs=512, band_valid=valid)
        pp, ph = fcq.encode_tiles_plain(
            xb, lob, hib, fcq.band_valid_array(3, 512, None, valid, dev), n,
            bits, 512)
        check(torch.equal(kp, pp) and torch.equal(kh, ph),
              f"encode_tiles banded N={n}")
    # device rANS: a 65536-element chunk at several level counts, plus a
    # sparse and a tiny stream; blobs byte-identical to the plain step
    # loop and to the host coder
    xs = boundary["prefill"].reshape(-1)[:CHUNK].float()
    streams = [(f"chunk N={n}", ops.clip_quantize(xs, cmin=lo, cmax=hi,
                                                  n_levels=n)[0], n)
               for n in (2, 3, 4, 16)]
    streams.append(("sparse N=4", (torch.rand(70000, device=dev,
                                              generator=gen) > 0.97).int()
                    * 3, 4))
    streams.append(("n=5 N=3", torch.tensor([0, 2, 1, 2, 0], device=dev,
                                            dtype=torch.int32), 3))
    for name, idx, n in streams:
        kernel_blob = rans_coder.encode_planes_device(idx, n)
        plain = rans_coder.encode_planes_device(idx.cpu(), n)
        check(kernel_blob == plain, f"rans blob vs plain step loop {name}")
        host = rans.encode_planes(binarization.index_to_context_bits(
            idx.cpu().numpy(), n))
        check(kernel_blob == host, f"rans blob vs host coder {name}")
        check(cabac.wrap_device_blob(kernel_blob)[1:]
              == cabac._encode_rans_sharded(idx.cpu().numpy(), n, 1)[1:],
              f"coder 4 vs host coder 2 {name}")
    # the prefill boundary's 16 chunks coded in one launch: the blobs of
    # 16 single-chunk launches, and of the plain step loop on the CPU
    idx = ops.clip_quantize(boundary["prefill"].float(), cmin=lo, cmax=hi,
                            n_levels=N_SERVE)[0].reshape(-1)
    bounds = [(i * CHUNK, (i + 1) * CHUNK) for i in range(16)]
    batch = rans_coder.encode_index_chunks_device(idx, N_SERVE, bounds)
    check(batch == [rans_coder.encode_index_chunks_device(idx, N_SERVE,
                                                          [b])[0]
                    for b in bounds], "rans 16 chunks in one launch vs "
          "16 single-chunk launches")
    check(batch[:2] == rans_coder.encode_index_chunks_device(
        idx[:2 * CHUNK].cpu(), N_SERVE, bounds[:2]),
        "rans 16-chunk batch vs plain step loop")
    return worst_deq


def pack_checks(dev):
    """Kernel #9 against its plain version (bytes identical) over bit
    widths 1/2/4, ragged sizes up to the prefill boundary's and views that
    are not 16-byte aligned; #1's packing variant against its plain
    version (bytes and bins) over N in {2, 3, 4, 16} at the widths that
    hold them, float32 and bfloat16, the same sizes, aligned or not, with
    values outside the clip range, and refusing N = 64 at 8 bits; and the
    CUDA backend's pack against the torch backend's for bits 1-8."""
    from repro_torch.core.backend import get_backend
    from repro_torch.kernels import fused_clip_quant as fcq
    from repro_torch.kernels import pack_bits as pb

    gen = torch.Generator(device=dev).manual_seed(9)
    sizes = (1, 7, 13, 16384, 70001, 1 << 20, (1 << 20) + 7)
    for bits in (1, 2, 4):
        for n in sizes:
            idx = torch.randint(0, 1 << bits, (n + 1,), device=dev,
                                generator=gen, dtype=torch.int32)
            for what, view in (("aligned", idx[:n]), ("unaligned", idx[1:])):
                check(torch.equal(pb.pack_bits(view, bits),
                                  pb.pack_bits_plain(view, bits)),
                      f"pack_bits bits={bits} n={n} {what}")
    lo, hi = -1.5, 2.75
    for n in (1, 7, 16384, 70001, 1 << 20):
        x0 = torch.randn(n + 1, device=dev, generator=gen) * 2.5 + 0.3
        for dtype in (torch.float32, torch.bfloat16):
            x = x0.to(dtype)
            for n_levels, bits in ((2, 1), (3, 2), (4, 2), (16, 4)):
                for what, view in (("aligned", x[:n]), ("unaligned", x[1:])):
                    kp, kh = fcq.clip_quant_pack(view, lo, hi, n_levels,
                                                 bits)
                    pp, ph = fcq.clip_quant_pack_plain(view, lo, hi,
                                                       n_levels, bits)
                    check(torch.equal(kp, pp) and torch.equal(kh, ph),
                          f"clip_quant_pack N={n_levels} bits={bits} n={n} "
                          f"{dtype} {what}")
    try:
        fcq.clip_quant_pack(x0, lo, hi, 64, 8)
    except ValueError:
        pass
    else:
        raise AssertionError("clip_quant_pack took N=64 at 8 bits")
    cuda, plain = get_backend("cuda"), get_backend("torch")
    for bits in range(1, 9):
        idx = torch.randint(0, 1 << bits, (4, 1, 4096), device=dev,
                            generator=gen, dtype=torch.int32)
        check(torch.equal(cuda.pack_indices(idx, bits).cpu(),
                          plain.pack_indices(idx.cpu(), bits)),
              f"CudaBackend.pack_indices bits={bits}")


def ecsq_tensor_checks(dev) -> None:
    """Kernel #7's variants against their plain versions: indices and
    reconstruction, indices alone, either with the histogram, and packed
    at every width that holds N with the histogram -- sizes from 1 to 4.8
    million values with ragged tails, aligned views and views that are
    not, values outside the clip range, N in {2, 4, 16, 64}, float32 and
    bfloat16; indices, bins and bytes exact, the reconstruction at 0
    units (torch.equal).  The refusals: N = 16 at 2 bits."""
    from repro_torch.kernels import ecsq_assign as ea

    gen = torch.Generator(device=dev).manual_seed(18)
    lo, hi = -2.0, 2.5
    variants = (dict(), dict(want_deq=False), dict(want_hist=True),
                dict(want_deq=False, want_hist=True))
    for n in (1, 7, 4095, 4097, 16384, 70001, 1 << 20, 4_800_003):
        x0 = torch.randn(n + 1, device=dev, generator=gen) * 2.5 + 0.3
        for n_levels in (2, 4, 16, 64):
            # host tables: the kernel takes them by value
            thr, lvl = (t.cpu() for t in ecsq_tables(
                torch.tensor(lo, device=dev), torch.tensor(hi, device=dev),
                n_levels, dev, seed=n_levels))
            for dtype in (torch.float32, torch.bfloat16):
                x = x0.to(dtype)
                for what, view in (("aligned", x[:n]), ("unaligned", x[1:])):
                    case = f"N={n_levels} n={n} {dtype} {what}"
                    for kw in variants:
                        k_out = ea.ecsq_assign(view, thr, lvl, lo, hi, **kw)
                        p_out = ea.ecsq_assign_plain(view, thr, lvl, lo, hi,
                                                     **kw)
                        check(all(a is None and b is None
                                  or torch.equal(a, b)
                                  for a, b in zip(k_out, p_out)),
                              f"ecsq_assign {kw} {case}")
                    for bits in (1, 2, 4):
                        if n_levels <= 1 << bits:
                            kp, kh = ea.ecsq_assign_pack(view, thr, lvl, lo,
                                                         hi, bits)
                            pp, ph = ea.ecsq_assign_pack_plain(
                                view, thr, lvl, lo, hi, bits)
                            check(torch.equal(kp, pp) and torch.equal(kh, ph),
                                  f"ecsq_assign_pack bits={bits} {case}")
    try:
        ea.ecsq_assign_pack(x0, thr[:15], lvl[:16], lo, hi, 2)
    except ValueError:
        pass
    else:
        raise AssertionError("ecsq_assign_pack took N=16 at 2 bits")


def tile_histogram_checks(boundary, dev) -> dict:
    """Kernel #5 against its plain version on each of its routes -- a warp
    a tile (the decode boundary under the g=8 plan of (c) and (l)), a
    block (the prefill boundary), a cluster (large tiles) -- channels
    innermost or not (a conv map, 1-D and a ragged 2-D plan through perm),
    N in {2, 3, 4, 16, 17, 64}, values outside [0, N): bins exact and one
    device operation a call.  Returns each case's device operations."""
    from repro_torch.core.tiling import TilePlan, spatial_grid
    from repro_torch.kernels import fused_clip_quant as fcq
    from repro_torch.kernels import rate_hist

    d_model = boundary["prefill"].shape[-1]
    conv = (2, 32, 28, 28)
    grid = spatial_grid(conv, 1)
    big = (4, 8, 64, 64)
    big_grid = spatial_grid(big, 1)
    cases = {
        "decode g8": ((4, 1, d_model), channel_plan(d_model)),
        "prefill g8": ((4, 64, d_model), channel_plan(d_model)),
        "conv inner>1": (conv, TilePlan(channel_axis=1, channel_group_size=3,
                                        spatial_block_size=0,
                                        n_channels=32)),
        "conv 2-D perm": (conv, TilePlan(
            channel_axis=1, channel_group_size=3, spatial_block_size=0,
            n_channels=32, spatial_extent=grid[0] * grid[1],
            spatial_hw=grid, spatial_block_hw=(5, 6))),
        "conv 2-D cluster": (big, TilePlan(
            channel_axis=1, channel_group_size=8, spatial_block_size=0,
            n_channels=8, spatial_extent=big_grid[0] * big_grid[1],
            spatial_hw=big_grid, spatial_block_hw=(40, 24))),
        "g64 block": ((32, 128), TilePlan(channel_axis=-1,
                                          channel_group_size=64,
                                          spatial_block_size=0,
                                          n_channels=128)),
        "g64 cluster": ((3000, 128), TilePlan(channel_axis=-1,
                                              channel_group_size=64,
                                              spatial_block_size=0,
                                              n_channels=128)),
    }
    gen = torch.Generator(device=dev).manual_seed(5)
    ops_of = {}
    for name, (shape, plan) in cases.items():
        n = int(np.prod(shape))
        maps = fcq.tile_maps(plan, shape, dev)
        for n_levels in (2, 3, 4, 16, 17, 64):
            idx = torch.randint(-2, n_levels + 2, (n,), device=dev,
                                generator=gen,
                                dtype=torch.int32).view(shape)
            check(torch.equal(
                rate_hist.index_histogram_tiles(idx, n_levels, plan),
                rate_hist.index_histogram_tiles_plain(idx, n_levels, maps)),
                f"index_histogram_tiles {name} N={n_levels}")
        ops_of[name] = device_ops(
            lambda i=idx, p=plan: rate_hist.index_histogram_tiles(i, 64, p))
        check(len(ops_of[name]) == 1
              and "index_histogram_tiles" in ops_of[name][0],
              f"index_histogram_tiles {name}: device operations "
              f"{ops_of[name]}")
    return {k: len(v) for k, v in ops_of.items()}


def two_stream_checks(dev) -> None:
    """The histograms of #4 (2^20 and 2^22 indices), #1 and #7 (2^20
    values each) launched 50 times each on each of two side streams,
    interleaved with no sync: every bin exact (each stream has its own
    ticket word)."""
    from repro_torch.kernels import ecsq_assign as ea
    from repro_torch.kernels import fused_clip_quant as fcq
    from repro_torch.kernels import ops, rate_hist

    gen = torch.Generator(device=dev).manual_seed(16)
    idx = [torch.randint(0, 16, (n,), device=dev, generator=gen,
                         dtype=torch.int32) for n in (1 << 20, 1 << 22)]
    x = (torch.randn(1 << 20, device=dev, generator=gen) * 2).to(
        torch.bfloat16)
    thr = torch.tensor([-0.9, 0.1, 1.2])
    lvl = torch.tensor([-1.5, -0.4, 0.6, 2.75])
    want = [rate_hist.index_histogram_plain(i, 16) for i in idx] + [
        fcq.clip_quant_plain(x, -1.5, 2.75, 4, want_deq=False,
                             want_hist=True)[2],
        ea.ecsq_assign_plain(x, thr, lvl, -1.5, 2.75, want_deq=False,
                             want_hist=True)[2]]
    streams = [torch.cuda.Stream(device=dev) for _ in range(2)]
    torch.cuda.synchronize()
    got = []
    for _ in range(50):
        for st in streams:
            with torch.cuda.stream(st):
                got.append((ops.index_histogram(idx[0], n_levels=16),
                            ops.index_histogram(idx[1], n_levels=16),
                            fcq.clip_quant_2d(x, -1.5, 2.75, 4,
                                              want_deq=False,
                                              want_hist=True)[2],
                            ea.ecsq_assign(x, thr, lvl, -1.5, 2.75,
                                           want_deq=False,
                                           want_hist=True)[2]))
    torch.cuda.synchronize()
    check(all(torch.equal(a, b) for out in got for a, b in zip(out, want)),
          "histograms on two streams at once differ from the plain version")


STEP_INDICES = [0]      # indices of the rANS batch being launched


def size_class(kernel: str, symbol: str, args) -> str:
    """"prefill" or "decode": the size of one launch, from its C entry's
    arguments (elements per call).  The step loop's arguments do not hold
    its size, so the indices of the batch it codes are recorded as the
    batch is dispatched (``STEP_INDICES``); a batch of at least one chunk
    but below the prefill size is a "chunk".  The per-tensor quantizers'
    (#1, #7) class also names what it wrote besides the indices: "" (the
    reconstruction), " +hist" (and the histogram), " idx+hist" (the
    histogram alone) or " idx" (neither); its packing variant " +pack"
    (packed bytes and the histogram, no indices).  The tiled quantizers
    name theirs the same way on their fast route (#8: "", " idx", or
    " coded" for coded order), and " element" (" element idx") on the
    element route."""
    if kernel == "decode_attention":
        return "decode"
    if kernel == "prefill_attention":
        return "prefill"
    if kernel == "clip_quant" and args[2] == TRAIN_N:
        return "train +hist" if args[10] is not None else "train"
    if symbol == "repro_clip_quant_pack":
        return ("prefill" if args[2] >= 600_000 else "decode") + " +pack"
    if kernel == "clip_quant":
        deq, hist = args[9] is not None, args[10] is not None
        return ("prefill" if args[2] >= 600_000 else "decode") + (
            " +hist" if deq and hist else " idx+hist" if hist
            else "" if deq else " idx")
    if symbol == "repro_clip_quant_tiles_fast":
        deq, hist = args[10] is not None, args[12] is not None
        return ("prefill" if args[2] * args[3] >= 600_000 else "decode") + (
            " +pack" if args[8] else " +hist" if deq and hist
            else " idx+hist" if hist else "" if deq else " idx")
    if symbol == "repro_ecsq_assign_pack":
        return ("prefill" if args[2] >= 600_000 else "decode") + " +pack"
    if symbol == "repro_ecsq_assign":
        deq, hist = args[9] is not None, args[10] is not None
        return ("prefill" if args[2] >= 600_000 else "decode") + (
            " +hist" if deq and hist else " idx+hist" if hist
            else "" if deq else " idx")
    if symbol == "repro_ecsq_assign_tiles_fast":
        return ("prefill" if args[2] * args[3] >= 600_000 else "decode") + (
            " coded" if args[12] else "" if args[11] is not None else " idx")
    if symbol in ("repro_clip_quant_tiles", "repro_ecsq_assign_tiles"):
        deq = args[12 if kernel == "clip_quant_tiles" else 14] is not None
        return ("prefill" if args[2] >= 600_000 else "decode") + (
            " element" if deq else " element idx")
    if kernel == "rans_step":
        n = STEP_INDICES[0]
        return "prefill" if n >= 600_000 else "chunk" if n >= CHUNK \
            else "decode"
    n = {"encode_tiles": lambda a: a[2] * a[3],
         "index_histogram": lambda a: a[1],
         "index_histogram_tiles": lambda a: a[4] * a[8],
         "pack_bits": lambda a: a[1]}.get(kernel, lambda a: a[2])(args)
    return "prefill" if n >= 600_000 else "decode"


SIZE_LAUNCHES: dict[tuple[str, str], int] = {}
RUN_SIZES: dict[str, dict] = {}     # run -> SIZE_LAUNCHES of that run


def count_sizes() -> None:
    """Count every launch also by its size class (``SIZE_LAUNCHES``),
    beside the wrappers' own per-kernel counts."""
    from repro_torch.kernels import _build, rans_coder
    real = _build.launch
    real_dispatch = rans_coder._dispatch

    def launch(kernel, symbol, *args):
        real(kernel, symbol, *args)
        key = (kernel, size_class(kernel, symbol, args))
        SIZE_LAUNCHES[key] = SIZE_LAUNCHES.get(key, 0) + 1

    def dispatch(coded, n_levels, bounds):
        STEP_INDICES[0] = sum(max(e - s, 0) for s, e in bounds)
        return real_dispatch(coded, n_levels, bounds)

    _build.launch = launch
    rans_coder._dispatch = dispatch


def start_probe_build():
    """Start ``nvcc`` on the chain probe, beside the kernels' build;
    returns (process, library path)."""
    from repro_torch.kernels import _build
    out = _build.BUILD_ROOT / "probe"
    out.mkdir(parents=True, exist_ok=True)
    lib = out / f"rans_chain_probe.{os.getpid()}.so"
    proc = subprocess.Popen([_build._nvcc(), *_build.NVCC_FLAGS, "-shared",
                             "-o", str(lib), str(PROBE)],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    return proc, lib


def chain_cycles(proc, lib_path: Path, dev) -> dict[str, float]:
    """Cycles per step of the rANS step's least dependent chain and of
    the shipped kernel's form of the step, one thread looping on the
    card; both forms must reach the same state."""
    import ctypes
    out, _ = proc.communicate()
    check(proc.returncode == 0, f"chain probe build failed:\n{out}")
    fn = ctypes.CDLL(str(lib_path)).rans_chain_probe
    fn.argtypes = (ctypes.c_void_p,) * 3 + (ctypes.c_int, ctypes.c_void_p)
    p1 = 4000
    p0 = (1 << 14) - p1
    m0, m1 = (-(-(1 << 63) // f) for f in (p0, p1))
    vals = [70001, p0 << 18, p1 << 18, m0 >> 32, m0 & 0xFFFFFFFF, m1 >> 32,
            m1 & 0xFFFFFFFF, p0, p1, 0x5A5A1234]
    inp = torch.tensor([v - (1 << 32) if v >= 1 << 31 else v for v in vals],
                       dtype=torch.int32, device=dev)
    cycles = torch.zeros(2, dtype=torch.int64, device=dev)
    states = torch.zeros(2, dtype=torch.int32, device=dev)
    for _ in range(3):                      # the last call is warm
        check(fn(inp.data_ptr(), cycles.data_ptr(), states.data_ptr(),
                 PROBE_ITERS, torch.cuda.current_stream().cuda_stream) == 0,
              "chain probe launch failed")
    torch.cuda.synchronize()
    check(states[0].item() == states[1].item(),
          "chain probe: the least chain's states differ from the kernel's "
          "form of the step")
    least, shipped = (c / PROBE_ITERS for c in cycles.tolist())
    return {"least": least, "shipped": shipped}


def chain_ms(steps: int, cycles: float, sm_mhz: float) -> float:
    """Least time of ``steps`` dependent rANS steps of ``cycles`` each at
    the card's top SM clock."""
    return steps * cycles / (sm_mhz * 1e3)


def kernel_timings(boundary, dev, sm_mhz: float, cycles: dict):
    """Time each kernel at the two sizes the main paths launch it at --
    the (4, 64, 4096) prefill boundary and the (4, 1, 4096) decode
    boundary of 16,384 values -- beside its plain version, its bound and
    a one-call library equivalent where one exists.  A row's top-level
    numbers are its first size's."""
    from repro_torch.kernels import _build, ops, rans_coder, rate_hist
    from repro_torch.kernels import ecsq_assign as ea
    from repro_torch.kernels import fused_clip_quant as fcq
    from repro_torch.kernels import pack_bits as pb

    lo, hi = boundary["range"]
    bnd = {"prefill": boundary["prefill"], "decode": boundary["decode"]}
    bits = bits_for(N_SERVE)
    per = 8 // bits
    rows, eager = [], {}

    def row(name, src, line, sizes):
        out = {}
        for size, c in sizes.items():
            b_ms, b_by = bound(c["nbytes"], c["nops"],
                               c.get("ops_per_s", FP32_OPS_PER_S))
            r = {"ms": time_ms(c["kernel"]),
                 "plain_ms": time_ms(c["plain"], **c.get("plain_kw", {})),
                 "bound_ms": b_ms, "bound_by": b_by,
                 "library_ms": None if c.get("library") is None
                 else eager_ms(c["library"]),
                 "max_abs_err": float(c["err"])}
            if "chain_steps" in c:
                r["byte_bound_ms"] = b_ms
                r["chain_cycles_per_step"] = cycles["least"]
                r["chain_ms"] = chain_ms(c["chain_steps"], cycles["least"],
                                         sm_mhz)
                if r["chain_ms"] > b_ms:
                    r["bound_ms"], r["bound_by"] = r["chain_ms"], "operations"
            eager[(name, size)] = eager_ms(c["kernel"])
            out[size] = r
        top = next(iter(out.values()))
        rows.append({"name": name, "route": "cuda",
                     "source": f"src/repro_torch/csrc/{src}",
                     "replaces": line, "launches": 0, **top, "sizes": out})

    def diff(a, b) -> float:
        return float((a.double() - b.double()).abs().max())

    # kernel 1: per-tensor clip + quantize, bf16 in: indices and
    # reconstruction (the codec= hookup's pass when the index histogram
    # was a launch of its own), then with the histogram of the
    # indices ("+hist"; the codec= hookup's apply_with_rate), and with
    # it but no reconstruction ("idx+hist"; the split crossing); bins
    # counted as 256 B as the index histogram's row counts them
    sizes = {}
    variants = {"": dict(), " +hist": dict(want_hist=True),
                " idx+hist": dict(want_deq=False, want_hist=True)}
    for tag, kw in variants.items():
        for size, x in bnd.items():
            n = x.numel()
            k_out = fcq.clip_quant_2d(x, lo, hi, N_SERVE, **kw)
            p_out = fcq.clip_quant_plain(x, lo, hi, N_SERVE, **kw)
            err = max(diff(a, b) for a, b in zip(k_out, p_out)
                      if a is not None)
            nbytes = n * (2 + 4 + (2 if kw.get("want_deq", True) else 0)) \
                + (64 * 4 if kw.get("want_hist") else 0)
            sizes[size + tag] = dict(
                kernel=lambda x=x, kw=kw: fcq.clip_quant_2d(
                    x, lo, hi, N_SERVE, **kw),
                plain=lambda x=x, kw=kw: fcq.clip_quant_plain(
                    x, lo, hi, N_SERVE, **kw),
                nbytes=nbytes, nops=6 * n, err=err)
    # and the packing variant: packed bytes and the histogram, no indices
    # (the packed split crossing of (h), (j), (k))
    for size, x in bnd.items():
        n = x.numel()
        kp, kh = fcq.clip_quant_pack(x, lo, hi, N_SERVE, bits)
        pp, ph = fcq.clip_quant_pack_plain(x, lo, hi, N_SERVE, bits)
        sizes[size + " +pack"] = dict(
            kernel=lambda x=x: fcq.clip_quant_pack(x, lo, hi, N_SERVE, bits),
            plain=lambda x=x: fcq.clip_quant_pack_plain(x, lo, hi, N_SERVE,
                                                        bits),
            nbytes=n * 2 + n // per + 64 * 4, nops=6 * n,
            err=max(diff(kp, pp), diff(kh, ph)))
    # and phase 6's launches: indices alone, float32 in, N=256 (the
    # harness's top rung; the encode megakernel's histogram holds 64
    # levels, so its codec quantizes through #1), on each family's
    # boundary size -- 2 x 32 tokens of d_model 2560, 4096 and 6144
    gen = torch.Generator(device=dev).manual_seed(6)
    for n in (163_840, 262_144, 393_216):
        x = torch.randn(n, device=dev, generator=gen) * 1.3 + 0.1
        kw = dict(want_deq=False)
        k_out = fcq.clip_quant_2d(x, lo, hi, 256, **kw)
        p_out = fcq.clip_quant_plain(x, lo, hi, 256, **kw)
        sizes[f"eval f32 N=256 {n}"] = dict(
            kernel=lambda x=x: fcq.clip_quant_2d(x, lo, hi, 256,
                                                 want_deq=False),
            plain=lambda x=x: fcq.clip_quant_plain(x, lo, hi, 256,
                                                   want_deq=False),
            nbytes=n * (4 + 4), nops=6 * n, err=diff(k_out[0], p_out[0]))
    # and phase 8's launch: the codec-in-the-loop training run (w) at
    # gemma3-1b's boundary, bf16 (8, 256, 1152), indices, reconstruction
    # and histogram (apply_with_rate)
    x = (torch.randn(TRAIN_BATCH, TRAIN_SEQ, TRAIN_N // (TRAIN_BATCH
                                                          * TRAIN_SEQ),
                     device=dev, generator=gen) * 1.3 + 0.1).to(torch.bfloat16)
    kw = dict(want_hist=True)
    k_out = fcq.clip_quant_2d(x, lo, hi, N_SERVE, **kw)
    p_out = fcq.clip_quant_plain(x, lo, hi, N_SERVE, **kw)
    check(torch.equal(k_out[0], p_out[0]) and torch.equal(k_out[2], p_out[2])
          and ulps(k_out[1], p_out[1]) <= 1,
          "clip_quant +hist at the training boundary")
    sizes["train +hist"] = dict(
        kernel=lambda x=x: fcq.clip_quant_2d(x, lo, hi, N_SERVE, **kw),
        plain=lambda x=x: fcq.clip_quant_plain(x, lo, hi, N_SERVE, **kw),
        nbytes=TRAIN_N * (2 + 4 + 2) + 64 * 4, nops=6 * TRAIN_N,
        err=max(diff(a, b) for a, b in zip(k_out, p_out)))
    row("clip_quant", "fused_clip_quant.cu",
        "src/repro/kernels/fused_clip_quant.py:26", sizes)

    # kernel 4: global index histogram, int32 indices, the whole wrapper
    # call (the library call syncs on its input's maximum, so it is timed
    # eagerly)
    sizes = {}
    for size, x in bnd.items():
        idx = fcq.clip_quant_2d(x, lo, hi, N_SERVE)[0].reshape(-1)
        n = idx.numel()
        kh = ops.index_histogram(idx, n_levels=N_SERVE)
        ph = rate_hist.index_histogram_plain(idx, N_SERVE)
        sizes[size] = dict(
            kernel=lambda i=idx: ops.index_histogram(i, n_levels=N_SERVE),
            plain=lambda i=idx: rate_hist.index_histogram_plain(i, N_SERVE),
            nbytes=n * 4 + 64 * 4, nops=n, err=diff(kh, ph),
            library=lambda i=idx: torch.bincount(i, minlength=N_SERVE))
    row("index_histogram", "rate_hist.cu",
        "src/repro/kernels/rate_hist.py:24", sizes)

    # kernel 3: the encode megakernel on the float32 boundary, flat route
    # (run (b)) and plan route (run (d), the banded view of the g=8
    # plan); timed through the C entry on the wrapper's buffers (the
    # wrapper copies its band-valid list from pageable host memory,
    # which waits for the stream)
    plan = channel_plan(bnd["prefill"].shape[-1])
    t_lo, t_hi = tile_ranges(plan, lo, hi, dev, seed=3)
    sizes, whole = {}, {}

    def encode_case(x2d, lo_r, hi_r, lay_args, valid):
        r, c = x2d.shape
        sb, nsb = lay_args
        kp, kh = fcq.encode_tiles_2d(x2d, lo_r, hi_r, N_SERVE, bits,
                                     sb_cols=sb, bs=sb,
                                     band_valid=valid.tolist())
        pp, ph = fcq.encode_tiles_plain(x2d, lo_r, hi_r, valid, N_SERVE,
                                        bits, sb)
        packed, hist = torch.empty_like(kp), torch.empty_like(kh)

        def launch():
            _build.launch("encode_tiles", "repro_encode_tiles",
                          x2d.data_ptr(), 0, r, c, sb, nsb, lo_r.data_ptr(),
                          hi_r.data_ptr(), valid.data_ptr(), N_SERVE, bits,
                          packed.data_ptr(), hist.data_ptr())

        launch()
        check(torch.equal(packed, kp) and torch.equal(hist, kh),
              "encode_tiles C entry vs wrapper")
        return dict(kernel=launch,
                    plain=lambda: fcq.encode_tiles_plain(
                        x2d, lo_r, hi_r, valid, N_SERVE, bits, sb),
                    nbytes=r * c * 4 + r * c // per + r * nsb * 64 * 4
                    + 2 * r * nsb * 4, nops=8 * r * c,
                    err=max(diff(kp, pp), diff(kh, ph)))

    # and at the transport tick's stacked size: TICK_SESSIONS decode
    # boundaries (262,144 values) in one launch, flat (run (r)) and on
    # the g=8 plan (run (s))
    tick_bnd = dict(bnd, **{"tick decode": boundary["tick"]})
    for size, x in tick_bnd.items():
        x2d, _ = ops._to_2d(x.float().reshape(-1), lo)
        r, c = x2d.shape
        sizes[size] = encode_case(
            x2d, torch.full((r, 1), float(lo), device=dev),
            torch.full((r, 1), float(hi), device=dev), (c, 1),
            fcq.band_valid_array(1, c, None, device=dev))
    for size, x in tick_bnd.items():
        xf = x.float()
        lay = ops.banded_layout(tuple(x.shape), plan)
        xp, _ = ops._banded_view(xf, lay, plan)
        lo_r, hi_r = ops._row_ranges(t_lo, t_hi, lay)
        sizes["plan " + size] = encode_case(
            xp, lo_r, hi_r, (lay.sb_cols, lay.n_sblocks),
            fcq.band_valid_array(lay.n_sblocks, lay.bs, lay.bs_last,
                                 device=dev))
        whole[size] = eager_ms(lambda xf=xf: ops.encode_fused(
            xf, t_lo, t_hi, n_levels=N_SERVE, bits=bits, plan=plan))
    row("encode_tiles", "fused_clip_quant.cu",
        "src/repro/kernels/fused_clip_quant.py:130", sizes)
    for size, ms in whole.items():
        print(f"encode_tiles plan route, whole ops.encode_fused call at the "
              f"{size} boundary (banded copy and range expansion "
              f"included), eager: {ms:.4f} ms")

    # kernel 6: the step loop of one 65,536-index chunk, of the prefill
    # boundary's 16 chunks in one launch, and of a decode tensor (16,384
    # indices, one stream); chain bound: the longest stream's steps, each
    # at the least chain's cycles measured by the probe in this run
    coded = {size: ops.clip_quantize(x.float().reshape(-1), cmin=lo,
                                     cmax=hi, n_levels=N_SERVE)[0]
             for size, x in bnd.items()}
    cases = {"chunk": (coded["prefill"][:CHUNK], [CHUNK]),
             "prefill": (coded["prefill"], [CHUNK] * 16),
             "decode": (coded["decode"], [coded["decode"].numel()])}
    sizes = {}
    for size, (idx, lengths) in cases.items():
        bt = rans_coder._plane_batch(idx, lengths, N_SERVE)
        lay = bt.lay
        args = (bt.bits, bt.segs, bt.table, sum(lay.lanes), lay.n_cells)
        kx, kov, kw = rans_coder.rans_steps(*args, max(lay.lanes))
        px, pov, pw = rans_coder.rans_steps_plain(*args)
        err = max(diff(kx.long() & 0xFFFFFFFF, px), diff(kov, pov),
                  diff(kw.long() & 0xFFFF, pw))
        steps = int(bt.table[:, 4].max())
        cells = lay.n_cells
        sizes[size] = dict(
            kernel=lambda a=args, m=max(lay.lanes):
                rans_coder.rans_steps(*a, m),
            plain=lambda a=args: rans_coder.rans_steps_plain(*a),
            plain_kw=dict(reps=1, trials=1) if size == "prefill"
            else dict(reps=2, trials=3),
            nbytes=cells * (1 + 1 + 2) + lay.n_segs * 8
            + len(lay.lanes) * 6 * 8 + sum(lay.lanes) * 4,
            nops=12 * cells, err=err, chain_steps=steps)
        print(f"rans_step {size}: {len(lengths)} stream(s), lanes "
              f"{sorted(set(lay.lanes))}, {steps} steps (longest stream), "
              f"{cells} cells")
    # the transport tick's chunk set: the device-entropy tick dispatches
    # each session's chunks on its own (one launch a session), so a decode
    # tick of TICK_SESSIONS sessions is that many decode-size launches
    # back to back; chain bound: the launches' chains one after another
    tick_idx = ops.clip_quantize(boundary["tick"].float().reshape(-1),
                                 cmin=lo, cmax=hi, n_levels=N_SERVE)[0]
    per = tick_idx.numel() // TICK_SESSIONS
    batches = [rans_coder._plane_batch(tick_idx[i * per:(i + 1) * per],
                                       [per], N_SERVE)
               for i in range(TICK_SESSIONS)]
    t_args = [((bt.bits, bt.segs, bt.table, sum(bt.lay.lanes),
                bt.lay.n_cells), max(bt.lay.lanes)) for bt in batches]
    err = 0.0
    for a, m in t_args:
        kx, kov, kw = rans_coder.rans_steps(*a, m)
        px, pov, pw = rans_coder.rans_steps_plain(*a)
        err = max(err, diff(kx.long() & 0xFFFFFFFF, px), diff(kov, pov),
                  diff(kw.long() & 0xFFFF, pw))
    sizes["tick decode"] = dict(
        kernel=lambda: [rans_coder.rans_steps(*a, m) for a, m in t_args],
        plain=lambda: [rans_coder.rans_steps_plain(*a) for a, _ in t_args],
        plain_kw=dict(reps=1, trials=1),
        nbytes=sum(bt.lay.n_cells * (1 + 1 + 2) + bt.lay.n_segs * 8
                   + len(bt.lay.lanes) * 6 * 8 + sum(bt.lay.lanes) * 4
                   for bt in batches),
        nops=12 * sum(bt.lay.n_cells for bt in batches), err=err,
        chain_steps=sum(int(bt.table[:, 4].max()) for bt in batches))
    print(f"rans_step tick decode: {TICK_SESSIONS} launches of one "
          f"{per}-index stream each, "
          f"{sum(bt.lay.n_cells for bt in batches)} cells")
    row("rans_step", "rans_coder.cu", "src/repro/kernels/rans_coder.py:265",
        sizes)
    dispatch = {}
    for size, (idx, lengths) in cases.items():
        ends = np.cumsum(lengths).tolist()
        bounds = list(zip([0] + ends[:-1], ends))
        dispatch[size] = eager_ms(
            lambda i=idx, b=bounds: rans_coder.encode_index_chunks_device(
                i, N_SERVE, b), reps=5)
    print("rans whole encode_index_chunks_device call (sizes pre-pass, "
          "plane build, step loop, words and fetch), eager: "
          + ", ".join(f"{k} {v:.4f} ms" for k, v in dispatch.items()))

    # kernels 2, 5, 7, 8 under the g=8 per-channel plan of runs (c)-(f)
    # and (l), 512 tiles, bf16 in/out.  #2 on its fast route: indices and
    # reconstruction; with the per-tile counts (" +hist", (c)'s stage);
    # indices alone (" idx", CudaBackend.quantize); with counts
    # (" idx+hist"); packed 2-bit with counts (" +pack", (l)'s stage).
    # #8 on its fast route: indices and reconstruction, indices alone,
    # indices in coded order (" coded", (f)'s device entropy input); its
    # library yardstick torch.searchsorted over the channel-major float32
    # view with the batched (n_tiles, N-1) table.  Bins count 4 B each,
    # range tables 8 B a tile.
    tiles = plan.n_tiles
    hist_b = tiles * N_SERVE * 4
    # #7's table in host memory (the kernel takes it by value), and on
    # the card for the library call
    thr1_dev, lvl1 = ecsq_tables(torch.tensor(lo, device=dev),
                                 torch.tensor(hi, device=dev), N_SERVE, dev,
                                 7)
    thr1, lvl1 = thr1_dev.cpu(), lvl1.cpu()
    thr, lvl = ecsq_tables(t_lo, t_hi, N_SERVE, dev, 8)
    s2, s5, s7, s8 = {}, {}, {}, {}
    for size, x in bnd.items():
        n = x.numel()
        maps = fcq.tile_maps(plan, x.shape, dev)
        variants = {"": dict(), " +hist": dict(want_hist=True),
                    " idx": dict(want_deq=False),
                    " idx+hist": dict(want_deq=False, want_hist=True)}
        for tag, kw in variants.items():
            k_out = fcq.clip_quant_tiles(x, t_lo, t_hi, N_SERVE, plan, **kw)
            p_out = fcq.clip_quant_tiles_plain(x, t_lo, t_hi, N_SERVE, maps,
                                               **kw)
            deq = kw.get("want_deq", True)
            s2[size + tag] = dict(
                kernel=lambda x=x, kw=kw: fcq.clip_quant_tiles(
                    x, t_lo, t_hi, N_SERVE, plan, **kw),
                plain=lambda x=x, m=maps, kw=kw: fcq.clip_quant_tiles_plain(
                    x, t_lo, t_hi, N_SERVE, m, **kw),
                nbytes=n * (2 + 4 + (2 if deq else 0)) + tiles * 8
                + (hist_b if kw.get("want_hist") else 0),
                nops=(10 if deq else 6) * n,
                err=max(diff(a, b) for a, b in zip(k_out, p_out)
                        if a is not None))
        kp, kh = fcq.clip_quant_tiles_pack(x, t_lo, t_hi, N_SERVE, plan,
                                           bits)
        pp, ph = fcq.clip_quant_tiles_pack_plain(x, t_lo, t_hi, N_SERVE,
                                                 maps, bits)
        s2[size + " +pack"] = dict(
            kernel=lambda x=x: fcq.clip_quant_tiles_pack(
                x, t_lo, t_hi, N_SERVE, plan, bits),
            plain=lambda x=x, m=maps: fcq.clip_quant_tiles_pack_plain(
                x, t_lo, t_hi, N_SERVE, m, bits),
            nbytes=n * 2 + n // per + tiles * 8 + hist_b, nops=6 * n,
            err=max(diff(kp, pp), diff(kh, ph)))
        ki = fcq.clip_quant_tiles(x, t_lo, t_hi, N_SERVE, plan)[0]
        kh = rate_hist.index_histogram_tiles(ki, N_SERVE, plan)
        ph = rate_hist.index_histogram_tiles_plain(ki, N_SERVE, maps)
        s5[size] = dict(
            kernel=lambda i=ki: rate_hist.index_histogram_tiles(
                i, N_SERVE, plan),
            plain=lambda i=ki, m=maps: rate_hist.index_histogram_tiles_plain(
                i, N_SERVE, m),
            nbytes=n * 4 + hist_b, nops=n, err=diff(kh, ph))
        # #7: indices and reconstruction; indices alone (" idx",
        # CudaBackend.quantize); with the histogram (" +hist", (e)'s
        # stage); with it and no reconstruction (" idx+hist"); packed
        # 2-bit with the histogram (" +pack", (n)'s stage).  The library
        # yardstick is torch.bucketize on a float32 copy (matching
        # dtypes), indices only.  Table 7 floats, bins 256 B.
        xf32 = x.float()
        variants = {"": dict(), " idx": dict(want_deq=False),
                    " +hist": dict(want_hist=True),
                    " idx+hist": dict(want_deq=False, want_hist=True)}
        for tag, kw in variants.items():
            k_out = ea.ecsq_assign(x, thr1, lvl1, lo, hi, **kw)
            p_out = ea.ecsq_assign_plain(x, thr1, lvl1, lo, hi, **kw)
            s7[size + tag] = dict(
                kernel=lambda x=x, kw=kw: ea.ecsq_assign(x, thr1, lvl1, lo,
                                                         hi, **kw),
                plain=lambda x=x, kw=kw: ea.ecsq_assign_plain(
                    x, thr1, lvl1, lo, hi, **kw),
                nbytes=n * (2 + 4 + (2 if kw.get("want_deq", True) else 0))
                + (2 * N_SERVE - 1) * 4
                + (64 * 4 if kw.get("want_hist") else 0),
                nops=(N_SERVE + 1) * n,
                err=max(diff(a, b) for a, b in zip(k_out, p_out)
                        if a is not None),
                library=lambda xf=xf32: torch.bucketize(xf, thr1_dev,
                                                        right=True))
        kp, kh = ea.ecsq_assign_pack(x, thr1, lvl1, lo, hi, bits)
        pp, ph = ea.ecsq_assign_pack_plain(x, thr1, lvl1, lo, hi, bits)
        s7[size + " +pack"] = dict(
            kernel=lambda x=x: ea.ecsq_assign_pack(x, thr1, lvl1, lo, hi,
                                                   bits),
            plain=lambda x=x: ea.ecsq_assign_pack_plain(x, thr1, lvl1, lo,
                                                        hi, bits),
            nbytes=n * 2 + n // per + (2 * N_SERVE - 1) * 4 + 64 * 4,
            nops=(N_SERVE + 1) * n, err=max(diff(kp, pp), diff(kh, ph)),
            library=lambda xf=xf32: torch.bucketize(xf, thr1_dev,
                                                    right=True))
        xcm = fcq.channel_major(x, maps).float().reshape(tiles, -1) \
            .contiguous()
        thr2 = thr.reshape(tiles, N_SERVE - 1).contiguous()
        tab_b = tiles * (2 + 2 * N_SERVE - 1) * 4
        for tag, kw in {"": dict(), " idx": dict(want_deq=False)}.items():
            k_out = ea.ecsq_assign_tiles(x, t_lo, t_hi, thr, lvl, plan, **kw)
            p_out = ea.ecsq_assign_tiles_plain(x, t_lo, t_hi, thr, lvl, maps,
                                               **kw)
            s8[size + tag] = dict(
                kernel=lambda x=x, kw=kw: ea.ecsq_assign_tiles(
                    x, t_lo, t_hi, thr, lvl, plan, **kw),
                plain=lambda x=x, m=maps, kw=kw: ea.ecsq_assign_tiles_plain(
                    x, t_lo, t_hi, thr, lvl, m, **kw),
                nbytes=n * (2 + 4 + (2 if kw == {} else 0)) + tab_b,
                nops=(N_SERVE + 1) * n,
                err=max(diff(a, b) for a, b in zip(k_out, p_out)
                        if a is not None),
                library=lambda xc=xcm: torch.searchsorted(thr2, xc,
                                                          right=True))
        kc = ea.ecsq_assign_tiles_coded(x, t_lo, t_hi, thr, lvl, plan)
        pc = ea.ecsq_assign_tiles_coded_plain(x, t_lo, t_hi, thr, lvl, maps)
        s8[size + " coded"] = dict(
            kernel=lambda x=x: ea.ecsq_assign_tiles_coded(
                x, t_lo, t_hi, thr, lvl, plan),
            plain=lambda x=x, m=maps: ea.ecsq_assign_tiles_coded_plain(
                x, t_lo, t_hi, thr, lvl, m),
            nbytes=n * (2 + 4) + tab_b, nops=(N_SERVE + 1) * n,
            err=diff(kc, pc),
            library=lambda xc=xcm: torch.searchsorted(thr2, xc, right=True))
    # (m)'s calls on its 2-D tile plan (4,096 tiles, the prefill
    # boundary): #2's element route, indices only, and #5
    t2d = tile2d_codec(bnd["prefill"])
    x = bnd["prefill"]
    n, tiles2 = x.numel(), t2d.plan.n_tiles
    maps = fcq.tile_maps(t2d.plan, x.shape, dev)
    lo2, hi2 = (ops._f32(t, dev, (t2d.plan.n_cgroups, t2d.plan.n_sblocks))
                for t in t2d.tile_tables())
    ki, _ = fcq.clip_quant_tiles(x, lo2, hi2, N_SERVE, t2d.plan,
                                 want_deq=False)
    pi, _ = fcq.clip_quant_tiles_plain(x, lo2, hi2, N_SERVE, maps,
                                       want_deq=False)
    s2["prefill element idx"] = dict(
        kernel=lambda: fcq.clip_quant_tiles(x, lo2, hi2, N_SERVE, t2d.plan,
                                            want_deq=False),
        plain=lambda: fcq.clip_quant_tiles_plain(x, lo2, hi2, N_SERVE, maps,
                                                 want_deq=False),
        nbytes=n * (2 + 4) + tiles2 * 8, nops=6 * n, err=diff(ki, pi))
    kh = rate_hist.index_histogram_tiles(ki, N_SERVE, t2d.plan)
    s5["2-D plan prefill"] = dict(
        kernel=lambda: rate_hist.index_histogram_tiles(ki, N_SERVE,
                                                       t2d.plan),
        plain=lambda: rate_hist.index_histogram_tiles_plain(ki, N_SERVE,
                                                            maps),
        nbytes=n * 4 + tiles2 * N_SERVE * 4, nops=n,
        err=diff(kh, rate_hist.index_histogram_tiles_plain(ki, N_SERVE,
                                                           maps)))
    row("clip_quant_tiles", "fused_clip_quant.cu",
        "src/repro/kernels/fused_clip_quant.py:55", s2)
    row("index_histogram_tiles", "rate_hist.cu",
        "src/repro/kernels/rate_hist.py:45", s5)
    row("ecsq_assign", "ecsq_assign.cu", "src/repro/kernels/ecsq_assign.py:28",
        s7)
    row("ecsq_assign_tiles", "ecsq_assign.cu",
        "src/repro/kernels/ecsq_assign.py:56", s8)

    # kernel 9: the pack of the split runtime's decode boundary (16,384
    # indices at N=4, 2 bits), the one size its path gives it, then the
    # prefill boundary's 1,048,576 indices
    sizes = {}
    for size in ("decode", "prefill"):
        idx = fcq.clip_quant_2d(bnd[size], lo, hi, N_SERVE)[0].reshape(-1)
        n = idx.numel()
        sizes[size] = dict(
            kernel=lambda i=idx: pb.pack_bits(i, bits),
            plain=lambda i=idx: pb.pack_bits_plain(i, bits),
            nbytes=n * 4 + n // per, nops=2 * n,
            err=diff(pb.pack_bits(idx, bits), pb.pack_bits_plain(idx, bits)))
    row("pack_bits", "pack_bits.cu", "src/repro/kernels/pack_bits.py:38",
        sizes)
    row("decode_attention", "decode_attention.cu", None,
        decode_attention_cases(dev))
    row("prefill_attention", "prefill_attention.cu", None,
        prefill_attention_cases(dev))

    check(all(r_["sizes"][s]["max_abs_err"] == 0 for r_ in rows
              for s in r_["sizes"]
              if r_["name"] not in ("clip_quant", "clip_quant_tiles",
                                    "decode_attention", "prefill_attention")),
          "integer kernel outputs and ECSQ reconstructions must match "
          "exactly")
    print("times per call: device time of back-to-back calls; 'eager' is "
          "the python-dispatched wall time per call")
    for r_ in rows:
        for size, t in r_["sizes"].items():
            print(f"  {r_['name']:21s} {size:12s} kernel {t['ms']:.4f} ms  "
                  f"eager {eager[(r_['name'], size)]:.4f} ms  plain "
                  f"{t['plain_ms']:.4f} ms  bound {t['bound_ms']:.5f} ms "
                  f"({t['bound_by']})"
                  + (f"  [bytes {t['byte_bound_ms']:.5f}, chain "
                     f"{t['chain_ms']:.4f} ms at "
                     f"{t['chain_cycles_per_step']:.2f} cycles a step]"
                     if "chain_ms" in t else "")
                  + (f"  library {t['library_ms']:.4f} ms (eager)"
                     if t["library_ms"] is not None else ""))
    return rows


def decode_attention_cases(dev) -> dict:
    """Kernel #10 at each of DA_SHAPES: the wrapper against the plain
    decode path (the masked float32 attention over the whole cache) at
    each position checked, within DA_TOL, with the slots past the
    prefix holding large values so that reading one would show; then the
    sizes ``row`` times at the last position checked, beside the plain
    path, its
    byte bound (the prefix of K and V read once) and
    ``F.scaled_dot_product_attention`` over the prefix."""
    import torch.nn.functional as F

    from repro_torch.kernels import decode_attention as DA
    from repro_torch.models import layers as L

    hd, sizes = 128, {}
    for name, (b, s, h, kh, checked) in DA_SHAPES.items():
        idx = torch.arange(s, dtype=torch.int32, device=dev)
        worst = 0.0
        for pos in checked:
            g = torch.Generator(device=dev).manual_seed(pos)
            q = torch.randn((b, 1, h, hd), device=dev, generator=g).to(
                torch.bfloat16)
            k, v = (torch.randn((b, s, kh, hd), device=dev, generator=g).to(
                torch.bfloat16) for _ in range(2))
            n = min(pos + 1, s)
            k[:, n:] = 1e4
            v[:, n:] = -1e4
            got = DA.decode_attention(q[:, 0], k, v, n).float()
            want = L.multi_head_attention(q, k, v, q_offset=pos,
                                          k_positions=idx).float()
            err = float((got - want).abs().max())
            check(bool(((got - want).abs() <= DA_TOL["atol"] + DA_TOL["rtol"]
                        * want.abs()).all()),
                  f"(#10) decode_attention {name} at pos {pos}: {err} from "
                  f"the plain path, beyond rtol {DA_TOL['rtol']} atol "
                  f"{DA_TOL['atol']}")
            worst = max(worst, err)
        print(f"decode_attention {name} ({b} x {s} slots, {h} / {kh} heads "
              f"of {hd}, bf16) at positions {checked}: within rtol "
              f"{DA_TOL['rtol']}, atol {DA_TOL['atol']} of the plain path "
              f"(largest difference {worst})")
        # the last position checked is the one timed; q, k, v are its
        sizes[name] = dict(
            kernel=lambda q=q, k=k, v=v, n=n: DA.decode_attention(
                q[:, 0], k, v, n),
            plain=lambda q=q, k=k, v=v, pos=pos, idx=idx:
                L.multi_head_attention(q, k, v, q_offset=pos,
                                       k_positions=idx),
            plain_kw=dict(reps=5),
            library=lambda q=q, k=k, v=v, n=n: F.scaled_dot_product_attention(
                q.transpose(1, 2), k[:, :n].transpose(1, 2),
                v[:, :n].transpose(1, 2), enable_gqa=True),
            nbytes=2 * b * n * kh * hd * 2, nops=4 * b * h * n * hd,
            err=worst)
    return sizes


def prefill_attention_cases(dev) -> dict:
    """Kernel #11 at each of PA_SHAPES: the wrapper against the plain
    prefill path (``multi_head_attention(q, k, v, q_offset=0)``, float32
    logits over the whole square) at each length checked, within PA_TOL;
    then the sizes ``row`` times at the last length checked, beside the
    plain path, its causal FLOP bound (both products over the pairs
    ``t <= s``) and ``F.scaled_dot_product_attention(is_causal=True)``."""
    import torch.nn.functional as F

    from repro_torch.kernels import prefill_attention as PA
    from repro_torch.models import layers as L

    hd, sizes = 128, {}
    for name, (b, h, kh, lengths) in PA_SHAPES.items():
        worst = 0.0
        for s in lengths:
            g = torch.Generator(device=dev).manual_seed(s)
            q, k, v = (torch.randn((b, s, n, hd), device=dev, generator=g)
                       .to(torch.bfloat16) for n in (h, kh, kh))
            with torch.inference_mode():
                got = PA.prefill_attention(q, k, v).float()
                want = L.multi_head_attention(q, k, v, q_offset=0).float()
            err = float((got - want).abs().max())
            check(bool(((got - want).abs() <= PA_TOL["atol"] + PA_TOL["rtol"]
                        * want.abs()).all()),
                  f"(#11) prefill_attention {name} at length {s}: {err} from "
                  f"the plain path, beyond rtol {PA_TOL['rtol']} atol "
                  f"{PA_TOL['atol']}")
            worst = max(worst, err)
        print(f"prefill_attention {name} ({b} rows, {h} / {kh} heads of "
              f"{hd}, bf16) at lengths {lengths}: within rtol "
              f"{PA_TOL['rtol']}, atol {PA_TOL['atol']} of the plain path "
              f"(largest difference {worst})")
        # the last length checked is the one timed; q, k, v are its
        sizes[name] = dict(
            kernel=lambda q=q, k=k, v=v: PA.prefill_attention(q, k, v),
            plain=lambda q=q, k=k, v=v: L.multi_head_attention(
                q, k, v, q_offset=0),
            plain_kw=dict(reps=5),
            library=lambda q=q, k=k, v=v: F.scaled_dot_product_attention(
                q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                is_causal=True, enable_gqa=True),
            nbytes=2 * b * s * (h + 2 * kh) * hd * 2,
            nops=2 * b * h * hd * s * (s + 1),
            ops_per_s=BF16_MMA_OPS_PER_S, err=worst)
    return sizes


# -- phase 4: serving ----------------------------------------------------------

def host_roundtrip(codec, seen: list):
    """The bitstream hookup: encode on the card (device entropy stage),
    decode on the host; keeps each boundary tensor and its payloads."""
    def host_fn(x):
        payloads = list(codec.encode_stream(x, chunk_elems=CHUNK,
                                            device_entropy=True))
        seen.append((x, payloads))
        recon = codec.decode_stream(payloads).reshape(x.shape)
        return recon, 8.0 * sum(map(len, payloads)) / x.size
    return host_fn


def wire_indices(x_pre, payloads, codec) -> np.ndarray:
    """Coded-order indices the prefill boundary's coder-4 chunks carry."""
    from repro_torch.core import cabac
    ce = CHUNK if codec.plan is None else \
        codec.plan.align_chunk_elems(CHUNK, x_pre.shape)
    idx = np.concatenate([
        cabac.decode_indices(p[4:], min(ce, x_pre.size - i * ce), N_SERVE)
        for i, p in enumerate(payloads[1:])])
    for i, p in enumerate(payloads[1:]):
        check(p[4] == 4 and p[5:] == cabac._encode_rans_sharded(
            idx[i * ce:(i + 1) * ce], N_SERVE, 1)[1:],
            f"chunk {i}: coder 4 != host coder 2")
    return idx


def calibrate_codecs(samples: np.ndarray) -> dict:
    """The four serving codecs from one set of warm-up activations
    ((tokens, d_model) float32), with their calibration seconds."""
    from repro_torch.core import CodecConfig, calibrate
    base = dict(n_levels=N_SERVE, clip_mode="model",
                constrain_cmin_zero=False, backend="cuda")
    channel = dict(granularity="channel", channel_axis=-1,
                   channel_group_size=GROUP)
    ecsq = dict(use_ecsq=True, ecsq_lagrangian=ECSQ_LAGRANGIAN)
    kinds = {"tensor": ({}, samples.reshape(-1)),
             "channel": (channel, samples),
             "ecsq_tensor": (ecsq, samples.reshape(-1)),
             "ecsq_channel": (dict(channel, **ecsq), samples)}
    codecs = {}
    for kind, (kw, data) in kinds.items():
        t0 = time.perf_counter()
        codecs[kind] = calibrate(CodecConfig(**base, **kw), samples=data)
        print(f"calibrated {kind} codec on {data.size} warm-up activations "
              f"in {time.perf_counter() - t0:.1f} s")
    return codecs


def serve(dev):
    from repro_torch.core.backend import _coded_order_device
    from repro_torch.kernels import _build, ops
    from repro_torch.kernels.fused_clip_quant import quantize_rows
    from repro_torch.launch import serve as S

    t0 = time.perf_counter()
    cfg, params = S.make_model("codeqwen1.5-7b", True, dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(t.numel() for t in _leaves(params))
    print(f"model: {cfg.name} {cfg.num_layers} layers d_model {cfg.d_model} "
          f"{n_params / 1e9:.2f} B params {cfg.dtype}; init {init_s:.1f} s")
    samples = S.warmup_samples(cfg, params, batches=WARMUP_BATCHES,
                               seq_len=min(64, PROMPT_LEN + NEW_TOKENS),
                               device=dev)
    codecs = calibrate_codecs(samples)
    run_kw = dict(requests=REQUESTS, prompt_len=PROMPT_LEN,
                  new_tokens=NEW_TOKENS, device=dev)
    counts, tok_s, rates, seen, tokens = {}, {}, {}, {}, {}

    # warm-up without a codec: the library's first calls at these shapes
    # (matmul heuristics, allocator growth) stay out of the timed runs
    print("serve warm-up (no codec):")
    S.run(cfg, params, **run_kw)

    rated = {"a": [], "c": [], "e": []}
    runs = {"a": ("tensor", "codec"), "b": ("tensor", "host"),
            "c": ("channel", "codec"), "d": ("channel", "host"),
            "e": ("ecsq_tensor", "codec"), "f": ("ecsq_channel", "host")}
    hookups = {}
    for run_id, (kind, hookup) in runs.items():
        codec = codecs[kind]
        if hookup == "codec":
            hookups[run_id] = dict(codec=rate_recorded(codec, rated[run_id])
                                   if run_id in rated else codec)
            label = "codec= hookup"
        else:
            seen[run_id] = []
            hookups[run_id] = dict(codec_host_fn=host_roundtrip(
                codec, seen[run_id]))
            label = ("codec_host_fn = decode_stream(encode_stream(x, "
                     f"chunk_elems={CHUNK}, device_entropy=True))")
        print(f"serve ({run_id}): {kind} codec, {label}")
        _build.reset_launches()
        SIZE_LAUNCHES.clear()
        eng, reqs, dt = S.run(cfg, params, **hookups[run_id], **run_kw)
        torch.cuda.synchronize()
        counts[run_id] = dict(_build.LAUNCHES)
        RUN_SIZES[run_id] = dict(SIZE_LAUNCHES)
        _check_retired(reqs)
        if run_id in rated:
            seen[run_id] = list(rated[run_id])
        tok_s[run_id] = REQUESTS * NEW_TOKENS / dt
        tokens[run_id] = [list(r.out_tokens) for r in reqs]
        rates[run_id] = float(np.mean(eng.rate_log))
    profiles = {run_id: profiled(f"({run_id})", lambda: S.run(
        cfg, params, **hookups[run_id], **run_kw)) for run_id in ("a", "b")}
    # one prefill boundary, then NEW_TOKENS - 1 decode boundaries; (a),
    # (c) and (e) count their indices in the quantizer's launch
    same_rates("(a)", codecs["tensor"], seen["a"], NEW_TOKENS)
    same_rates("(c)", codecs["channel"], seen["c"], NEW_TOKENS)
    same_rates("(e)", codecs["ecsq_tensor"], seen["e"], NEW_TOKENS)
    # (f): every boundary's payloads against the parent's route to the
    # device entropy stage (the element route's indices, reconstruction
    # written, permuted to coded order by a copy)
    same_payloads("(f)", codecs["ecsq_channel"], seen["f"])

    # the prefill boundary of each bitstream run: the wire's indices
    # against the quantizer kernel's on the same tensor
    for run_id in ("b", "d", "f"):
        codec = codecs[runs[run_id][0]]
        x_pre, payloads = seen[run_id][0]
        check(x_pre.shape == (REQUESTS, PROMPT_LEN, cfg.d_model),
              f"prefill boundary shape {x_pre.shape}")
        wire = wire_indices(x_pre, payloads, codec)
        xt = torch.as_tensor(x_pre, device=dev)
        if run_id == "b":
            # the wire carries the megakernel's tiled formula (float32
            # span and divide on the device), the clip-quant kernel the
            # per-tensor one (scale divided in double): the wire must hold
            # the tiled formula's indices exactly, and differs from the
            # clip-quant kernel only where those two roundings do
            k_idx = ops.clip_quantize(xt, cmin=codec.cmin, cmax=codec.cmax,
                                      n_levels=N_SERVE)[0]
            lo_t = torch.tensor([[np.float32(codec.cmin)]], device=dev)
            hi_t = torch.tensor([[np.float32(codec.cmax)]], device=dev)
            t_idx = quantize_rows(xt.reshape(1, -1), lo_t, hi_t,
                                  N_SERVE).reshape(-1).cpu().numpy()
            check(np.array_equal(wire, t_idx),
                  "(b) wire indices differ from the megakernel formula")
            print(f"(b) prefill boundary: {x_pre.size} wire indices equal "
                  "the clip-quant kernel's but for "
                  f"{int((t_idx != k_idx.reshape(-1).cpu().numpy()).sum())} "
                  "elements where the per-tensor and tiled range formulas "
                  "round apart")
            continue
        # (d) and (f): one formula on both sides, so no exception
        k_idx = codec.backend.quantize(xt, codec.spec())
        coded = _coded_order_device(k_idx, codec.spec()).cpu().numpy()
        check(np.array_equal(wire, coded),
              f"({run_id}) wire indices differ from the "
              f"{'ECSQ' if codec.tile_ecsq is not None else 'clip-quant'} "
              "tile kernel's")
        print(f"({run_id}) prefill boundary: {x_pre.size} wire indices "
              "equal the tile kernel's in coded order, no exception")
    print(f"coder-4 payloads of the prefill boundaries of (b), (d), (f) "
          "equal host coder 2 past the id byte")
    print("serve summary: " + "; ".join(
        f"({r}) {runs[r][0]} {'estimated' if runs[r][1] == 'codec' else 'wire'}"
        f" {rates[r]:.4f} bits/element {tok_s[r]:.1f} tok/s" for r in runs)
        + f"; init {init_s:.1f} s")
    served = dict(seen=seen, tokens=tokens, tok_s=tok_s, profiles=profiles,
                  run_kw=run_kw)
    return cfg, params, counts, codecs, served


def same_payloads(label: str, codec, seen: list) -> None:
    """Each recorded boundary's payloads equal those the parent's route
    gives (``coded_indices_device`` as the quantize-dequantize kernel's
    indices permuted to coded order), byte for byte."""
    from repro_torch.core import backend as B

    def parent_route(self, x, spec, bits):
        spec = B._normalize(spec)
        return B._coded_order_device(self.quantize_dequantize(x, spec)[0],
                                     spec)

    for x, payloads in seen:
        real = B.CudaBackend.coded_indices_device
        B.CudaBackend.coded_indices_device = parent_route
        try:
            before = list(codec.encode_stream(x, chunk_elems=CHUNK,
                                              device_entropy=True))
        finally:
            B.CudaBackend.coded_indices_device = real
        check(before == payloads, f"{label} payloads differ from the "
              "parent's route")
    print(f"{label}: {len(seen)} boundaries, each boundary's payloads equal "
          "the parent's route's")


def tile2d_codec(pre):
    """(m)'s 2-D tile codec: groups of GROUP channels by blocks of 2 x 16
    positions, ranges by min/max of ``pre``."""
    from repro_torch.core import CodecConfig, calibrate
    codec = calibrate(CodecConfig(
        n_levels=N_SERVE, clip_mode="minmax", constrain_cmin_zero=False,
        granularity="tile", channel_axis=-1, channel_group_size=GROUP,
        spatial_block_hw=(2, 16), backend="cuda"),
        pre.float().cpu().numpy())
    check(codec.plan.is_2d, "(m) tile codec plan")
    return codec


def codec_calls(boundary, codecs, dev) -> dict:
    """Run (m): the codec calls that still launch the standalone tile
    histogram (#5), pack (#9) and index histogram (#4) --
    ``FeatureCodec.tile_rate_bits`` of a 2-D tile codec on the seeded
    prefill boundary (its quantizer takes the element route),
    ``FeatureCodec.pack`` of the per-channel ECSQ codec's indices of the
    decode boundary, and ``rate_from_indices`` of the per-tensor ECSQ
    codec's -- each against its two-step definition.  Returns the run's
    launch counts."""
    from repro_torch.core import CodecConfig, calibrate
    from repro_torch.core.rate_model import estimated_bits_from_tile_hists
    from repro_torch.kernels import _build, pack_bits, rate_hist
    from repro_torch.kernels import fused_clip_quant as fcq
    pre, dec = boundary["prefill"], boundary["decode"]
    tile2d = tile2d_codec(pre)
    ecsq = codecs["ecsq_channel"]
    ecsq_t = codecs["ecsq_tensor"]
    _build.reset_launches()
    SIZE_LAUNCHES.clear()
    bits_2d = tile2d.tile_rate_bits(pre)
    idx = ecsq.quantize(dec)
    packed = ecsq.pack(idx)
    idx_t = ecsq_t.quantize(dec)
    rate_t = ecsq_t.rate_from_indices(idx_t, tuple(dec.shape))
    torch.cuda.synchronize()
    counts = dict(_build.LAUNCHES)
    RUN_SIZES["m"] = dict(SIZE_LAUNCHES)
    q2 = tile2d.quantize(pre)
    want = estimated_bits_from_tile_hists(
        rate_hist.index_histogram_tiles_plain(
            q2, N_SERVE, fcq.tile_maps(tile2d.plan, pre.shape, dev)),
        N_SERVE, per_tile=True)
    check(torch.equal(bits_2d, want), "(m) tile_rate_bits")
    check(torch.equal(packed, pack_bits.pack_bits_plain(
        idx.reshape(-1), ecsq.bits_per_index())), "(m) pack")
    check(float(rate_t) == float(ecsq_t.rate_from_counts(
        rate_hist.index_histogram_plain(idx_t, N_SERVE), tuple(dec.shape))),
        "(m) rate_from_indices")
    print(f"codec calls (m): tile_rate_bits of a 2-D tile codec "
          f"({tile2d.plan.n_tiles} tiles) on the prefill boundary, pack of "
          "the per-channel ECSQ codec's decode indices, rate_from_indices "
          "of the per-tensor ECSQ codec's: launches "
          + ", ".join(f"{k} {v}" for k, v in counts.items() if v))
    return counts



# -- phase 5: the packed split runtime -------------------------------------------

def split_codecs(cfg, params, half: int, dev) -> dict:
    """The split runs' codecs, calibrated in "model" mode from the serve
    phase's warm-up batches at the split runtime's boundary."""
    from repro_torch.core import CodecConfig, calibrate
    from repro_torch.launch import serve as S
    samples = S.warmup_samples(cfg, params, batches=WARMUP_BATCHES,
                               seq_len=min(64, PROMPT_LEN + NEW_TOKENS),
                               device=dev, split_after=half)
    base = dict(clip_mode="model", constrain_cmin_zero=False, backend="cuda")
    kinds = {"tensor-2": (dict(n_levels=2), samples.reshape(-1)),
             "tensor-4": (dict(n_levels=4), samples.reshape(-1)),
             "tensor-16": (dict(n_levels=16), samples.reshape(-1)),
             "channel-4": (dict(n_levels=4, granularity="channel",
                                channel_axis=-1, channel_group_size=GROUP),
                           samples),
             "ecsq-4": (dict(n_levels=4, use_ecsq=True,
                             ecsq_lagrangian=ECSQ_LAGRANGIAN),
                        samples.reshape(-1))}
    codecs = {}
    for kind, (kw, data) in kinds.items():
        t0 = time.perf_counter()
        codecs[kind] = calibrate(CodecConfig(**base, **kw), samples=data)
        print(f"calibrated split codec {kind} on {data.size} activations "
              f"after layer {half} in {time.perf_counter() - t0:.1f} s")
    return codecs


def link_counted(codec, sent: list, rated: list, payloads: list):
    """``codec`` with the bytes of each payload it sends appended to
    ``sent`` -- the int32 indices, or the packed bytes that replace them,
    whether the quantizer packed them or the pack kernel did -- each
    boundary with its rate to ``rated``, and each packed payload, the
    quantizer's or the pack kernel's, to ``payloads``."""
    import dataclasses

    class Counted(type(codec)):
        def quantize_with_counts(self, x, want_deq=False):
            idx, deq, hist = super().quantize_with_counts(x, want_deq)
            sent.append(idx.numel() * idx.element_size())
            rated.append((x.clone(), self.rate_from_counts(hist, x.shape)))
            return idx, deq, hist

        def quantize_packed_with_counts(self, x):
            packed, hist = super().quantize_packed_with_counts(x)
            sent.append(packed.numel() * packed.element_size())
            rated.append((x.clone(), self.rate_from_counts(hist, x.shape)))
            payloads.append(packed.clone())
            return packed, hist

        def pack(self, idx):
            out = super().pack(idx)
            sent[-1] = out.numel() * out.element_size()
            payloads.append(out.clone())
            return out

    return Counted(**{f.name: getattr(codec, f.name)
                      for f in dataclasses.fields(codec)})


def split_decode(step, params, caches, prompt, n_prompt=SPLIT_PROMPT,
                 n_new=SPLIT_NEW):
    """Feed ``prompt`` (B, n_prompt) one token per step, then greedy tokens
    until ``n_new`` have been fed.  Returns (logits per step, generated
    tokens (B, n_new), mean rate bits, seconds)."""
    logits_all, rates, fed = [], [], []
    tok = prompt[:, 0]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for pos in range(n_prompt + n_new):
        logits, caches, rate = step(params, tok, caches, pos)
        logits_all.append(logits)
        rates.append(rate)
        nxt = logits.argmax(-1)
        tok = prompt[:, pos + 1] if pos + 1 < n_prompt else nxt
        if pos + 1 >= n_prompt:
            fed.append(nxt)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    return (torch.stack(logits_all), torch.stack(fed[:n_new], 1),
            float(np.mean([float(r) for r in rates])), dt)


def one_process_parts(cfg, codec, sp, inputs, dev) -> dict:
    """Median ms of the parts of (h)'s one-process packed step from its
    spans (:func:`traced_steps`), as phase 11 times its ranks: edge
    stage, crossing (the payload's ``.to`` on the same card), cloud stage
    and the whole step."""
    from repro_torch.compression import split_runtime as SR
    step = SR.make_split_decode_step(cfg, codec, transport="packed",
                                     edge_device=dev, cloud_device=dev)
    caches = SR.init_split_cache(cfg, inputs.shape[1], SPLIT_MAX_SEQ,
                                 edge_device=dev, cloud_device=dev)
    spans = traced_steps(inputs.shape[0],
                         lambda pos: step(sp, inputs[pos], caches, pos))
    return step_parts(spans, spans, ONE_PROCESS_PARTS)


def traced_steps(steps: int, run) -> list[dict]:
    """Calls ``run(i)`` of a split step for each of ``steps`` steps,
    traced: the tracer on with a device sync at each span's ends (the
    host clock then reads when the work issued inside the span is done),
    each call inside a ``split_step`` span.  Returns each step's spans,
    ``{stage: (start, end)}`` in seconds of the host clock, which the
    processes share."""
    from repro_torch.obs.tracing import span, tracer
    tr = tracer()
    tr.configure(enabled=True, sync=torch.cuda.synchronize)
    tr.reset()
    try:
        for i in range(steps):
            with span("split_step"):
                run(i)
        events = tr.snapshot_events()
    finally:
        tr.configure(enabled=False, sync=None)
        tr.reset()
    per = {e["span_id"]: {} for e in events if e["stage"] == "split_step"}
    for e in events:
        if e["parent_id"] in per:
            per[e["parent_id"]][e["stage"]] = (e["t_start"],
                                              e["t_start"] + e["dur_s"])
    return [per[k] for k in sorted(per)]


def fed_tokens(prompt, generated) -> torch.Tensor:
    """The (steps, B) tokens ``split_decode`` fed: the prompt, then the
    greedy tokens."""
    return torch.cat([prompt, generated], 1).t().contiguous()


def split_phase(cfg, params, dev) -> tuple[dict, dict]:
    """Runs (g)-(l) and (n) of the packed split runtime; returns their
    launch counts, and what phase 11 holds its ranks to: (g)'s and (h)'s
    tokens fed, logits, (h)'s payloads, rates and codec, and the median
    ms of the parts of (h)'s step."""
    from repro_torch.compression import split_runtime as SR
    from repro_torch.kernels import _build
    from repro_torch.models import decode_step, init_cache

    half, tail = SR.stage_layout(cfg)
    check((half, tail) == (16, 0), f"stage layout {half} + {tail}")
    sp = SR.split_params(cfg, params, edge_device=dev, cloud_device=dev)
    check(sp["edge"]["layers"][0]["attn"]["wq"]
          is params["layers"][0]["attn"]["wq"],
          "the split view must share the weights, not copy them")
    codecs = split_codecs(cfg, params, half, dev)
    b = REQUESTS
    prompt = torch.as_tensor(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (b, SPLIT_PROMPT)), device=dev)
    steps = SPLIT_PROMPT + SPLIT_NEW

    # the unsplit decode step on the same tokens (and a warm-up)
    cache = init_cache(cfg, b, SPLIT_MAX_SEQ, device=dev)

    def unsplit_step(params_, tok, cache_, pos):
        with torch.inference_mode():
            logits, cache_, _ = decode_step(cfg, params_, tok, cache_, pos)
        return logits.to(torch.bfloat16).to(torch.float32), cache_, 0.0

    ref_logits, ref_tok, _, ref_s = split_decode(unsplit_step, params, cache,
                                                 prompt)
    print(f"split: unsplit decode_step, {steps} steps in {ref_s:.2f} s")

    counts, out, ranks_ref = {}, {}, {}
    for run_id, (transport, kind) in SPLIT_RUNS.items():
        sent: list = []
        rated: list = []
        payloads: list = []
        codec = None if kind is None else link_counted(codecs[kind], sent,
                                                       rated, payloads)
        step = SR.make_split_decode_step(cfg, codec, transport=transport,
                                         edge_device=dev, cloud_device=dev)
        caches = SR.init_split_cache(cfg, b, SPLIT_MAX_SEQ, edge_device=dev,
                                     cloud_device=dev)
        _build.reset_launches()
        SIZE_LAUNCHES.clear()
        logits, toks, rate, dt = split_decode(step, sp, caches, prompt)
        counts[run_id] = dict(_build.LAUNCHES)
        RUN_SIZES[run_id] = dict(SIZE_LAUNCHES)
        if transport == "raw":      # the bf16 activations cross
            sent = [b * cfg.d_model * 2] * steps
        check(len(sent) == steps, f"({run_id}) sent {len(sent)} payloads")
        check(bool(torch.isfinite(logits).all()) and logits.shape
              == (steps, b, cfg.vocab_size), f"({run_id}) logits")
        out[run_id] = (logits, toks)
        agree = float((toks == out["g"][1]).float().mean())
        print(f"split ({run_id}) {transport} {kind or 'no codec'}: "
              f"{b * SPLIT_NEW / dt:.1f} tok/s ({dt / steps * 1e3:.1f} ms "
              f"per step), rate {rate:.4f} bits/element, link "
              f"{sent[0]} bytes per step, greedy tokens agree with (g) "
              f"{agree:.3f}")
        bits = 16 if kind is None else codecs[kind].bits_per_index()
        per = 8 // bits if bits in (1, 2, 4) else 1
        want = {"raw": b * cfg.d_model * 2,
                "packed": -(-b * cfg.d_model // per),
                "quantized_f16": b * cfg.d_model * 4}[transport]
        check(set(sent) == {want}, f"({run_id}) link bytes {set(sent)} != "
              f"{want}")
        fused = transport == "packed" and codec.packs_in_quantizer()
        check(fused == (run_id in "hjkln"), f"({run_id}) fused {fused}")
        packs = counts[run_id]["pack_bits"]
        check(packs == (steps if transport == "packed" and not fused
                        else 0),
              f"({run_id}) pack_bits launched {packs} times")
        check(len(payloads) == (steps if transport == "packed" else 0),
              f"({run_id}) {len(payloads)} packed payloads recorded")
        if kind is not None:
            same_rates(f"({run_id})", codecs[kind], rated, steps)
        for (x, _), packed in zip(rated, payloads):
            two = codecs[kind].pack(codecs[kind].quantize(x).reshape(-1))
            check(torch.equal(packed, two), f"({run_id}) the quantizer's "
                  "packed payload differs from quantize, then pack")
        if run_id in "gh":
            ranks_ref[run_id] = {
                "inputs": fed_tokens(prompt, toks).cpu(),
                "logits": logits.cpu(),
                "payloads": [p.cpu() for p in payloads],
                "rates": [float(r) for _, r in rated],
                "codec": None if kind is None else codecs[kind]}
        if run_id == "h":
            profiled("(h)", lambda: split_decode(
                step, sp, SR.init_split_cache(cfg, b, SPLIT_MAX_SEQ,
                                              edge_device=dev,
                                              cloud_device=dev), prompt))
            ranks_ref["h"]["parts"] = one_process_parts(
                cfg, codecs[kind], sp, ranks_ref["h"]["inputs"].to(dev), dev)
            print("split (h), ms per step (median) with a device sync "
                  "ending each part, as phase 11 times its ranks: "
                  + ", ".join(f"{k} {v:.3f}" for k, v in
                              ranks_ref["h"]["parts"].items()))

    diff = float((out["g"][0] - ref_logits).abs().max())
    print(f"split (g) vs the unsplit decode_step rounded through bfloat16: "
          f"largest logit difference {diff} over {steps} steps (bound 0: "
          "the same layers run in the same order through the same ops)")
    check(diff == 0 and torch.equal(out["g"][1], ref_tok),
          "(g) differs from the unsplit decode step")
    check(torch.equal(out["h"][0], out["i"][0])
          and torch.equal(out["h"][1], out["i"][1]),
          "(h) and (i) must give identical logits and tokens: the pack is "
          "lossless")
    print("split checks: (g) equals the unsplit decode; (h) and (i) "
          "identical; (h), (j), (k), (l) and (n) pack in the quantizer's "
          "launch, each payload the bytes of quantize, then pack; pack_bits "
          "never launched in (g)-(l), (n)")
    return counts, ranks_ref


# -- phase 5b: the socket transport ------------------------------------------

def loopback_serve(cfg, params, codecs, served) -> dict:
    """(q): the serve run of (b) with its boundary tensors sent through
    the port's loopback transport (``launch.serve._loopback_codec_fn``:
    a CloudServer on its own event-loop thread, a blocking edge client,
    ``chunk_elems`` CHUNK).  The client codes with (b)'s device entropy
    stage (``REPRO_ENTROPY_DEVICE=1``), so the codec, the coder and the
    reconstruction are (b)'s and only the socket differs: the tokens must
    equal (b)'s, each boundary's wire rate (frames included) must exceed
    (b)'s payload rate of the same boundary, and the server must count a
    session for every crossing.  Returns the run's launch counts."""
    from repro_torch.kernels import _build
    from repro_torch.launch import serve as S
    from repro_torch.serving.batcher import device_entropy
    seen_b = served["seen"]["b"][:NEW_TOKENS]     # (b)'s timed run
    run_kw = served["run_kw"]
    rates, calls = [], [0]
    with device_entropy():
        host_fn, cleanup = S._loopback_codec_fn(codecs["tensor"], CHUNK)

        def counted(x):
            calls[0] += 1
            recon, rate = host_fn(x)
            rates.append(rate)
            return recon, rate

        try:
            torch.cuda.synchronize()
            _build.reset_launches()
            SIZE_LAUNCHES.clear()
            eng, reqs, dt = S.run(cfg, params, codec_host_fn=counted,
                                  **run_kw)
            torch.cuda.synchronize()
            counts = dict(_build.LAUNCHES)
            RUN_SIZES["q"] = dict(SIZE_LAUNCHES)
            timed = list(rates)
            prof = profiled("(q)", lambda: S.run(
                cfg, params, codec_host_fn=counted, **run_kw))
        finally:
            link = cleanup()
    _check_retired(reqs)
    check([list(r.out_tokens) for r in reqs] == served["tokens"]["b"],
          "(q) tokens differ from (b)'s")
    check(len(timed) == len(seen_b), f"(q) crossed {len(timed)} "
          f"boundaries, (b) {len(seen_b)}")
    for i, ((x, payloads), rate) in enumerate(zip(seen_b, timed)):
        b_rate = 8.0 * sum(map(len, payloads)) / x.size
        check(rate > b_rate, f"(q) boundary {i}: wire rate {rate} is not "
              f"above (b)'s payload rate {b_rate}")
    check(link["sessions_served"] == calls[0], f"(q) server served "
          f"{link['sessions_served']} sessions for {calls[0]} crossings")
    for k in ("encode_tiles", "rans_step"):
        check(counts[k] > 0, f"(q): {k} never launched")
    pb = served["profiles"]["b"]
    b_mean = float(np.mean([8.0 * sum(map(len, p)) / x.size
                            for x, p in seen_b]))
    print(f"(q) loopback serve: tokens equal (b)'s; {len(timed)} "
          f"boundaries, wire {float(np.mean(timed)):.4f} bits/element "
          f"(b) payload {b_mean:.4f}; "
          f"{REQUESTS * NEW_TOKENS / dt:.1f} tok/s vs (b) "
          f"{served['tok_s']['b']:.1f}; profile wall {prof['wall_ms']:.1f} "
          f"ms busy {prof['busy_ms']:.1f} ms idle share "
          f"{prof['idle_share']:.3f} vs (b) wall {pb['wall_ms']:.1f} ms busy "
          f"{pb['busy_ms']:.1f} ms idle share {pb['idle_share']:.3f}; "
          f"server sessions {link['sessions_served']}, ticks "
          f"{link.get('ticks', 0)}")
    return counts


def tick_run(run_id: str, label: str, codec, seen: list) -> dict:
    """(r)/(s): one async EdgeClient opens TICK_SESSIONS concurrent
    sessions, each sending the recorded boundaries ``seen`` of a
    bitstream serve run in order, through the client's encode tick
    (``TickConfig(max_wait_s=0.002, max_batch=TICK_SESSIONS,
    device_entropy=True)``) to a port CloudServer on its default tick.
    Every tensor's payloads must be the serve run's (``encode_stream(x,
    chunk_elems=CHUNK, device_entropy=True)``), every echoed
    reconstruction ``decode_stream`` of them, each tick one stacked
    launch per group of at most TICK_SESSIONS same-geometry sessions and
    one step-loop launch per session.  Returns the run's launch counts."""
    import asyncio
    from collections import Counter

    from repro_torch.kernels import _build
    from repro_torch.serving import TickConfig
    from repro_torch.transport import CloudServer, EdgeClient
    from repro_torch.transport import client as client_mod
    xs = [np.asarray(x, np.float32) for x, _ in seen]
    want = [p for _, p in seen]
    recon = [codec.decode_stream(p).reshape(x.shape)
             for x, p in zip(xs, want)]
    index = {id(x): i for i, x in enumerate(xs)}
    ticks = []
    real = client_mod.encode_tick

    def recording(items, cfg):
        payloads, stats = real(items, cfg)
        ticks.append(([index[id(x)] for _, x in items], payloads, stats))
        return payloads, stats

    tick = TickConfig(max_wait_s=0.002, max_batch=TICK_SESSIONS,
                      device_entropy=True)

    async def session(client):
        return [await client.submit(x) for x in xs]

    async def run():
        async with CloudServer(echo_features=True,
                               backend=codec.backend) as srv:
            async with EdgeClient("127.0.0.1", srv.port, codec=codec,
                                  chunk_elems=CHUNK, tick=tick) as client:
                res = await asyncio.gather(*(session(client)
                                             for _ in range(TICK_SESSIONS)))
                return res, dict(client.encode_counters), srv.counters

    client_mod.encode_tick = recording
    torch.cuda.synchronize()
    _build.reset_launches()
    SIZE_LAUNCHES.clear()
    t0 = time.perf_counter()
    try:
        results, enc, srv_c = asyncio.run(asyncio.wait_for(run(), 600))
    finally:
        client_mod.encode_tick = real
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(_build.LAUNCHES)
    RUN_SIZES[run_id] = dict(SIZE_LAUNCHES)
    n = TICK_SESSIONS * len(xs)
    fused = 0
    for ids, payloads, stats in ticks:
        for i, p in zip(ids, payloads):
            check(p == want[i], f"({run_id}) boundary {i}: tick payloads "
                  "differ from encode_stream's")
        # per-tensor codecs stack any shapes; a plan stacks one geometry
        groups = Counter(0 if codec.plan is None else xs[i].shape
                         for i in ids)
        expect = sum(-(-k // TICK_SESSIONS) for k in groups.values())
        check(stats.fused_launches == expect, f"({run_id}) a tick of "
              f"{stats.sessions} sessions made {stats.fused_launches} "
              f"fused launches, not {expect}")
        fused += stats.fused_launches
    check(sum(s.sessions for _, _, s in ticks) == n == enc["sessions"],
          f"({run_id}) ticks coded {enc['sessions']} tensors, not {n}")
    check(enc["stacked_sessions"] > 0, f"({run_id}) no stacked session")
    for res in results:
        for i, r in enumerate(res):
            check(np.array_equal(np.asarray(r.arrays[0]), recon[i]),
                  f"({run_id}) boundary {i}: echoed reconstruction differs "
                  "from decode_stream")
    check(srv_c["sessions_served"] == n, f"({run_id}) server served "
          f"{srv_c['sessions_served']} of {n}")
    quantizer = "encode_tiles"
    check(counts[quantizer] == fused, f"({run_id}) {quantizer} launched "
          f"{counts[quantizer]} times for {fused} fused launches")
    check(counts["rans_step"] == n, f"({run_id}) rans_step launched "
          f"{counts['rans_step']} times for {n} sessions")
    bits = 8.0 * sum(r.coded_bytes for res in results for r in res)
    elems = sum(r.n_elems for res in results for r in res)
    print(f"({run_id}) {label}: {TICK_SESSIONS} sessions x {len(xs)} "
          f"boundaries, wall {wall:.2f} s, {n / wall:.1f} tensors/s, ticks "
          f"{enc['ticks']}, fused launches {enc['fused_launches']} (at most "
          f"{max(s.fused_launches for _, _, s in ticks)} a tick), entropy "
          f"calls {enc['entropy_calls']}, stacked sessions "
          f"{enc['stacked_sessions']}, wire {bits / elems:.4f} "
          f"bits/element, server ticks {srv_c['ticks']} (occupancy "
          f"{srv_c['batch_occupancy_avg']:.2f}); launches "
          + ", ".join(f"{k} {v}" for k, v in counts.items() if v))
    return counts


def cli_run() -> dict:
    """(t): ``repro_torch.launch.serve.main`` at the reduced size with the
    loopback transport through a dispatcher over two in-process workers;
    no session may be shed.  Returns the run's launch counts."""
    from repro_torch.kernels import _build
    from repro_torch.launch import serve as S
    torch.cuda.synchronize()
    _build.reset_launches()
    SIZE_LAUNCHES.clear()
    t0 = time.perf_counter()
    link = S.main(["--arch", "codeqwen1.5-7b", "--codec-levels", "4",
                   "--transport", "loopback", "--workers", "2",
                   "--tick-ms", "1"])
    torch.cuda.synchronize()
    counts = dict(_build.LAUNCHES)
    RUN_SIZES["t"] = dict(SIZE_LAUNCHES)
    check(link["routed_sessions"] > 0, "(t) no session routed")
    check(link["shed_sessions"] == 0,
          f"(t) {link['shed_sessions']} sessions shed")
    print(f"(t) serve CLI, --transport loopback --workers 2: "
          f"{time.perf_counter() - t0:.1f} s wall, "
          f"{link['routed_sessions']} sessions routed, 0 shed; launches "
          + ", ".join(f"{k} {v}" for k, v in counts.items() if v))
    return counts


def transport_phase(cfg, params, codecs, served) -> dict:
    """Phase 5b: (q) the loopback serve, (r) and (s) the encode tick
    across sessions with the per-tensor and the per-channel g=8 codec on
    the boundaries of (b)'s and (d)'s timed runs (one prefill, then
    NEW_TOKENS - 1 decode boundaries; the profiled repeat of (b) recorded
    its own after them), (t) the serve CLI over two workers.  Returns
    each run's launch counts."""
    t0 = time.perf_counter()
    counts = {"q": loopback_serve(cfg, params, codecs, served),
              "r": tick_run("r", "tick, per-tensor", codecs["tensor"],
                            served["seen"]["b"][:NEW_TOKENS]),
              "s": tick_run("s", f"tick, per-channel g={GROUP}",
                            codecs["channel"],
                            served["seen"]["d"][:NEW_TOKENS]),
              "t": cli_run()}
    print(f"transport phase: {time.perf_counter() - t0:.1f} s wall")
    return counts


# -- phase 6: the accuracy harness ---------------------------------------------

# scenario -> (published config it runs at full width, layers kept; None =
# all): dbrx-132b's 40 layers (~264 GB in bf16) do not fit one card, two do
EVAL_FULL = {"transformer-tensor": ("codeqwen1.5-7b", None),
             "moe-expert": ("dbrx-132b", 2),
             "rwkv-state": ("rwkv6-3b", None),
             "rglru-state": ("recurrentgemma-2b", None)}
EVAL_KERNELS = ("clip_quant", "clip_quant_tiles", "encode_tiles")


def eval_model(name: str, dev):
    """The published config of scenario ``name`` at full width (depth cut
    where ``EVAL_FULL`` says), random weights drawn on the card from the
    scenario's seed."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.eval import SCENARIOS
    from repro_torch.models import init_params
    arch, layers = EVAL_FULL[name]
    cfg = get_config(arch)
    if layers is not None:
        cfg = dataclasses.replace(cfg, num_layers=layers)
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(SCENARIOS[name].seed)
    params = init_params(cfg, gen, device=dev)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    print(f"eval model: {cfg.name} {cfg.num_layers} of "
          f"{get_config(arch).num_layers} layers, d_model {cfg.d_model}, "
          f"{n_params / 1e9:.2f} B params {cfg.dtype}; init "
          f"{time.perf_counter() - t0:.1f} s")
    return cfg, params


def eval_launches(label: str, launches: dict) -> None:
    """Print a sweep's launches of #1, #2 and #3; #1 and #3 must have
    launched (the default matrix's codecs are all per-tensor, so #2
    runs only in the codec check)."""
    print(f"{label} launches: "
          + ", ".join(f"{k} {launches[k]}" for k in EVAL_KERNELS))
    for k in ("clip_quant", "encode_tiles"):
        check(launches[k] > 0, f"{label}: {k} never launched")


def eval_cases(label: str, cases, wall_s: float) -> None:
    """Check one sweep's cases and print them."""
    for c in cases:
        check(c.bits_per_elem == c.coded_bytes * 8.0 / c.n_elems,
              f"{label} {c.clip_mode} N={c.rung}: bits_per_elem "
              f"{c.bits_per_elem!r} is not coded_bytes * 8 / n_elems")
        check(np.isfinite(c.logit_rmse), f"{label} {c.clip_mode} "
              f"N={c.rung}: logits not finite (rmse {c.logit_rmse})")
        check(c.n_decisive > 0, f"{label}: no decisive token")
    print(f"{label}: {wall_s:.2f} s wall, {cases[0].n_decisive} decisive "
          "tokens")
    for c in cases:
        print(f"  {c.clip_mode:10s} N={c.rung:4d} bpe={c.bits_per_elem:.4f} "
              f"deg={c.degradation:.4f} raw_deg={c.raw_degradation:.4f} "
              f"logit_rmse={c.logit_rmse:.5f} bytes={c.coded_bytes}")


def codec_agreement(name: str, cfg, params, tokens, split_after: int,
                    dev) -> int:
    """On the scenario's calibration boundary at full width, a CUDA-backend
    codec and a ``backend="torch"`` copy of it (the same calibration)
    give identical payload bytes and indices, and reconstructions within
    1 ulp: per-tensor (#1 at N=256, #3 at 16 and 4) and per-channel g=8
    (#2 at N=256, #3's plan route at 16 and 4) at every rung, minmax
    ranges.  Returns the worst reconstruction distance in ulps."""
    import dataclasses

    from repro_torch.core import calibrate
    from repro_torch.eval import SCENARIOS
    from repro_torch.eval.harness import codec_config_for
    from repro_torch.models import forward_from_boundary, forward_head
    sc = SCENARIOS[name]
    with torch.inference_mode():
        x = forward_head(cfg, params, torch.as_tensor(tokens, device=dev),
                         split_after=split_after).float()
        logits = forward_from_boundary(cfg, params, x,
                                       split_after=split_after)
    check(bool(torch.isfinite(logits).all()), f"{name}: logits not finite")
    host = x.cpu().numpy()
    worst = 0
    for grain in (sc, dataclasses.replace(sc, granularity="channel",
                                          channel_group_size=GROUP)):
        for rung in sc.rungs:
            label = f"{name} {grain.granularity} N={rung}"
            cuda = calibrate(codec_config_for(grain, rung, "minmax"), host)
            plain = dataclasses.replace(cuda, config=dataclasses.replace(
                cuda.config, backend="torch"))
            payloads = list(cuda.encode_stream(host))
            check(payloads == list(plain.encode_stream(host)),
                  f"{label}: payloads differ from the torch backend's")
            check(torch.equal(cuda.quantize(x).cpu(),
                              plain.quantize(x.cpu())),
                  f"{label}: indices differ from the torch backend's")
            u = ulps(torch.from_numpy(cuda.decode_stream(payloads)),
                     torch.from_numpy(plain.decode_stream(payloads)))
            check(u <= 1, f"{label}: reconstruction {u} ulp apart")
            worst = max(worst, u)
    return worst


def eval_full_width(name: str, cfg, params, dev) -> dict:
    """(o): scenario ``name``'s sweep through the harness's ``_sweep`` on a
    full-width model, launch counts reset just before it and read just
    after, then the codec check on its boundary."""
    from repro_torch.eval import SCENARIOS
    from repro_torch.eval import harness as H
    from repro_torch.kernels import _build
    sc = SCENARIOS[name]
    sa = H._default_tap(cfg)
    ev, cal = H._token_batches(sc, cfg.vocab_size)
    torch.cuda.synchronize()
    _build.reset_launches()
    t0 = time.perf_counter()
    cases, _ = H._sweep(sc, cfg, params, ev, cal, sa, None, dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(_build.LAUNCHES)
    label = f"eval (o) {name} on {cfg.name} split after {sa}"
    eval_cases(label, cases, wall)
    eval_launches(label, launches)
    worst = codec_agreement(name, cfg, params, cal, sa, dev)
    print(f"eval (o) {name}: CUDA and torch codecs agree on the boundary "
          f"(payloads and indices exact, reconstruction {worst} ulp)")
    return launches


def eval_loopback(cfg, params, dev) -> None:
    """``transformer-loopback`` at full width on the serve weights,
    through a real localhost socket, and its ``transport="inproc"`` twin:
    case by case the same degradation, and strictly more coded bytes on
    the socket (frame headers)."""
    import dataclasses

    from repro_torch.eval import SCENARIOS
    from repro_torch.eval import harness as H
    sc = SCENARIOS["transformer-loopback"]
    sa = H._default_tap(cfg)
    ev, cal = H._token_batches(sc, cfg.vocab_size)
    out = {}
    for transport in ("loopback", "inproc"):
        t0 = time.perf_counter()
        cases, _ = H._sweep(dataclasses.replace(sc, transport=transport),
                            cfg, params, ev, cal, sa, None, dev)
        torch.cuda.synchronize()
        eval_cases(f"eval (o) {sc.name} transport={transport} on "
                   f"{cfg.name} split after {sa}", cases,
                   time.perf_counter() - t0)
        out[transport] = cases
    for cl, ci in zip(out["loopback"], out["inproc"]):
        label = f"{sc.name} {cl.clip_mode} N={cl.rung}"
        check(cl.degradation == ci.degradation, f"{label}: degradation "
              f"{cl.degradation} on the socket, {ci.degradation} in process")
        check(cl.coded_bytes > ci.coded_bytes, f"{label}: socket bytes "
              f"{cl.coded_bytes} not above in-process {ci.coded_bytes}")
    print(f"eval (o) {sc.name}: loopback and inproc agree case by case "
          "(degradation equal, socket bytes larger)")


def eval_matrix(dev) -> dict:
    """(p): the registered smoke-size default matrix through
    ``run_matrix`` on the card."""
    from repro_torch.eval import load_matrix, run_matrix
    from repro_torch.kernels import _build
    torch.cuda.synchronize()
    _build.reset_launches()
    t0 = time.perf_counter()
    reports = run_matrix(load_matrix("default"), device=dev)
    torch.cuda.synchronize()
    launches = dict(_build.LAUNCHES)
    wall = time.perf_counter() - t0
    for rep_name, rep in reports.items():
        eval_cases(f"eval (p) {rep_name} split after {rep.split_after}",
                   rep.cases, rep.elapsed_s)
    eval_launches(f"eval (p) default matrix, {wall:.2f} s wall", launches)
    return launches


def eval_phase(cfg, params: list, dev) -> dict:
    """Phase 6: (o) the default matrix's four scenarios at full width --
    codeqwen1.5-7b on the serve phase's weights (taken from ``params``, a
    one-item list, which is emptied so they are freed before the next
    model is built), then dbrx-132b (two layers), rwkv6-3b and
    recurrentgemma-2b -- and (p) the smoke-size matrix.  Returns the
    launch counts of the phase's sweeps, summed."""
    import gc
    t0 = time.perf_counter()
    total = dict.fromkeys(EVAL_KERNELS, 0)

    def add(launches):
        for k in total:
            total[k] += launches[k]

    serve_params = params.pop()
    add(eval_full_width("transformer-tensor", cfg, serve_params, dev))
    eval_loopback(cfg, serve_params, dev)
    del serve_params
    for name in ("moe-expert", "rwkv-state", "rglru-state"):
        gc.collect()
        torch.cuda.empty_cache()
        m_cfg, m_params = eval_model(name, dev)
        add(eval_full_width(name, m_cfg, m_params, dev))
        del m_params
    gc.collect()
    torch.cuda.empty_cache()
    add(eval_matrix(dev))
    print(f"eval phase: {time.perf_counter() - t0:.1f} s wall (model "
          "builds and codec checks included)")
    return total


# -- phase 8: training ------------------------------------------------------------

TRAIN_ARCH = "gemma3-1b"
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 8, 256, 8
TRAIN_N = TRAIN_BATCH * TRAIN_SEQ * 1152    # (w)'s boundary, gemma3-1b d_model
CODEC_STEPS = 4
# (y): bf16 on the card against float32 on the CPU, relative
TRAIN_LOSS_RTOL, TRAIN_GNORM_RTOL = 2e-2, 5e-2


def timed_steps(step, times: list):
    """``step`` wrapped to append its wall seconds, between two device
    syncs, to ``times``."""
    def run(*args):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = step(*args)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        return out
    return run


def steady_ms(times: list) -> float:
    """Median ms of steps 2 onward (the first two warm the libraries)."""
    return statistics.median(times[2:]) * 1e3


def step_split(cfg, dcfg, tr, state) -> dict:
    """Where (u)'s step goes: the forward and backward pass, then the
    AdamW update, each between device syncs; then one whole step under
    ``torch.profiler`` for the device's busy time and idle share."""
    from repro_torch.data import stream
    from repro_torch.models import loss_and_grads
    from repro_torch.optim import adamw_update

    batch = next(stream(dcfg, TRAIN_STEPS))
    tokens = torch.as_tensor(batch["tokens"], device=state["opt"]["step"]
                             .device)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, grads = loss_and_grads(cfg, state["params"], tokens, remat=False)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    out = adamw_update(tr.opt_cfg, state["params"], grads, state["opt"])
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    del grads, out
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t3 = time.perf_counter()
        tr._step(state["params"], state["opt"], state["ef"], batch,
                 TRAIN_STEPS)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t3) * 1e3
    by_name: dict[str, float] = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0.0) \
                + e.time_range.elapsed_us() / 1e3
    busy_ms = sum(by_name.values())
    kinds = {"matmul": ("gemm", "xmma", "nvjet", "cutlass"),
             "elementwise": ("elementwise",), "reduction": ("reduce",)}
    share = dict.fromkeys([*kinds, "other"], 0.0)
    for name, ms in by_name.items():
        kind = next((k for k, keys in kinds.items()
                     if any(w in name.lower() for w in keys)), "other")
        share[kind] += ms
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    print(f"(u) step split: forward + backward {(t1 - t0) * 1e3:.1f} ms, "
          f"AdamW {(t2 - t1) * 1e3:.1f} ms (wall, between syncs); one step "
          f"under torch.profiler: wall {wall_ms:.1f} ms, "
          + (f"device busy {busy_ms:.1f} ms (idle share "
             f"{1 - busy_ms / wall_ms:.3f}): "
             + ", ".join(f"{k} {v:.1f}" for k, v in share.items())
             + " ms; top kernels: " + "; ".join(
                 f"{n[:60]} {v:.1f}" for n, v in top)
             if by_name else "no device kernel recorded: busy time not "
             "measured"))
    return {"fwd_bwd_ms": (t1 - t0) * 1e3, "adamw_ms": (t2 - t1) * 1e3,
            "profiled_wall_ms": wall_ms,
            "busy_ms": busy_ms if by_name else None,
            "busy_by_kind_ms": share if by_name else None}


def train_plain(cfg, dcfg, root: Path, dev) -> dict:
    """(u): ``Trainer.run`` for TRAIN_STEPS steps, one final async
    checkpoint; the checkpoint restored equals the state bit for bit."""
    import shutil

    from repro_torch.train import Trainer, TrainerConfig
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.tree import leaves

    n_params = cfg.param_count()
    need = n_params * (2 + 4 + 4 + 4)       # params, mu, nu, error feedback
    free = shutil.disk_usage(root).free
    check(free > need * 1.1, f"(u) needs {need * 1.1 / 1e9:.1f} GB free "
          f"under {root} for its checkpoint; {free / 1e9:.1f} GB free")
    tcfg = TrainerConfig(steps=TRAIN_STEPS, ckpt_every=TRAIN_STEPS,
                         ckpt_dir=str(root / "u"), ckpt_async=True,
                         warmup_steps=2, seed=0)
    tr = Trainer(cfg, tcfg, dcfg, device=dev)
    times, saved = [], {}
    tr._step = timed_steps(tr._step, times)
    real_save = tr._save

    def save(step, state):
        t0 = time.perf_counter()
        real_save(step, state)          # host snapshot, then the thread
        saved["snapshot_s"] = time.perf_counter() - t0
        tr.wait_for_checkpoint()
        saved["total_s"] = time.perf_counter() - t0

    tr._save = save
    torch.cuda.reset_peak_memory_stats()
    state = tr.run(resume=False)
    peak = torch.cuda.max_memory_allocated()
    losses = [m["loss"] for m in tr.metrics_log]
    check(all(np.isfinite(losses)) and losses[-1] < losses[0],
          f"(u) loss not finite and falling: {losses}")
    split = step_split(cfg, dcfg, tr, state)
    step_dir = Path(tcfg.ckpt_dir) / f"step_{TRAIN_STEPS:08d}"
    ckpt_bytes = sum(f.stat().st_size for f in step_dir.iterdir())
    t0 = time.perf_counter()
    back = ckpt.restore(tcfg.ckpt_dir, TRAIN_STEPS, state)
    restore_s = time.perf_counter() - t0
    n_leaves = 0
    for (_, a), (_, b) in zip(leaves(state), leaves(back), strict=True):
        check(a.dtype == b.dtype and torch.equal(a, b),
              "(u) the restored checkpoint differs from the state in memory")
        n_leaves += 1
    del back, state
    shutil.rmtree(tcfg.ckpt_dir)
    out = {"losses": losses, "step_ms": steady_ms(times),
           "peak_gb": peak / 1e9, "ckpt_gb": ckpt_bytes / 1e9,
           "ckpt_snapshot_s": saved["snapshot_s"],
           "ckpt_write_s": saved["total_s"], "restore_s": restore_s,
           "leaves": n_leaves, **split}
    print(f"(u) {cfg.name} {n_params / 1e9:.3f} B params, batch "
          f"{TRAIN_BATCH} x {TRAIN_SEQ}: loss {losses[0]:.4f} -> "
          f"{losses[-1]:.4f}; step {out['step_ms']:.1f} ms (median of "
          f"steps 2-{TRAIN_STEPS - 1}); peak {out['peak_gb']:.2f} GB; "
          f"checkpoint {out['ckpt_gb']:.2f} GB of {n_leaves} leaves, "
          f"host snapshot {saved['snapshot_s']:.1f} s, written in "
          f"{saved['total_s']:.1f} s; restored in {restore_s:.1f} s, equal "
          "bit for bit")
    return out


def train_compressed(cfg, dcfg, root: Path, dev) -> dict:
    """(v): TRAIN_STEPS steps with 4-bit gradient compression and error
    feedback, through the trainer's step method."""
    from repro_torch.compression import GradCompressionConfig
    from repro_torch.data import stream
    from repro_torch.train import Trainer, TrainerConfig

    tcfg = TrainerConfig(steps=TRAIN_STEPS, ckpt_dir=str(root / "v"),
                         warmup_steps=2, seed=0,
                         grad_compression=GradCompressionConfig(n_levels=16))
    tr = Trainer(cfg, tcfg, dcfg, device=dev)
    state = tr.init_state()
    times, metrics = [], []
    step = timed_steps(tr._step, times)
    p, o, e = state["params"], state["opt"], state["ef"]
    del state
    for i, batch in zip(range(TRAIN_STEPS), stream(dcfg)):
        p, o, e, m = step(p, o, e, batch, i)
        metrics.append({k: float(v) for k, v in m.items()})
    losses = [m["loss"] for m in metrics]
    mse = [m["grad_compress_mse"] for m in metrics]
    check(all(np.isfinite(losses)) and losses[-1] < losses[0]
          and all(np.isfinite(mse)),
          f"(v) loss not finite and falling: {losses}")
    out = {"losses": losses, "grad_compress_mse": mse,
           "step_ms": steady_ms(times)}
    print(f"(v) grad compression N=16: loss {losses[0]:.4f} -> "
          f"{losses[-1]:.4f}; grad_compress_mse "
          + ", ".join(f"{v:.3e}" for v in mse)
          + f"; step {out['step_ms']:.1f} ms")
    return out


def train_codec(cfg, dcfg, dev) -> dict:
    """(w): the codec in the loop -- a per-tensor N=4 codec calibrated in
    "model" mode from one forward's boundary, ``codec_fn=codec.
    apply_with_rate`` through ``make_train_step`` for CODEC_STEPS steps.
    The leaves before the boundary get zero gradients and the decay-only
    update; kernel #1 launches once a step."""
    from repro_torch.core import CodecConfig, calibrate
    from repro_torch.data import stream
    from repro_torch.kernels import _build
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import (build_groups, forward_head, init_params,
                                    loss_and_grads)
    from repro_torch.optim import AdamWConfig, init_opt_state
    from repro_torch.tree import leaves

    gen = torch.Generator(device=dev).manual_seed(0)
    params = init_params(cfg, gen, device=dev)
    batches = [torch.as_tensor(b["tokens"], device=dev)
               for _, b in zip(range(CODEC_STEPS), stream(dcfg))]
    with torch.no_grad():
        x = forward_head(cfg, params, batches[0])
    check(x.numel() == TRAIN_N, f"(w) boundary {tuple(x.shape)}")
    codec = calibrate(CodecConfig(n_levels=4, clip_mode="model",
                                  constrain_cmin_zero=False, backend="cuda"),
                      samples=x.float().cpu().numpy().reshape(-1))
    groups, _ = build_groups(cfg, split=True)
    n_head = groups[0].n_periods * len(groups[0].specs)
    (_, aux), grads = loss_and_grads(cfg, params, batches[0],
                                     codec_fn=codec.apply_with_rate,
                                     remat=True)
    head = [g for path, g in leaves(grads)
            if path[0] == "layers" and path[1] < n_head]
    tail = [g for path, g in leaves(grads)
            if path[0] == "layers" and path[1] >= n_head]
    check(all(not g.any() for g in head) and all(g.any() for g in tail),
          "(w) gradients: zero before the boundary, non-zero after")
    del grads
    opt_cfg = AdamWConfig()
    step = make_train_step(cfg, opt_cfg=opt_cfg,
                           codec_fn=codec.apply_with_rate)
    opt = init_opt_state(params)
    times, rates, losses, moved = [], [], [], 0
    lr = torch.tensor(opt_cfg.lr, device=dev)
    _build.reset_launches()
    SIZE_LAUNCHES.clear()
    for tokens in batches:
        before = [p for path, p in leaves(params)
                  if path[0] == "layers" and path[1] < n_head]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, opt, m = step(params, opt, {"tokens": tokens})
        rates.append(float(m["codec_rate_bits"]))
        losses.append(float(m["loss"]))
        times.append(time.perf_counter() - t0)
        after = [p for path, p in leaves(params)
                 if path[0] == "layers" and path[1] < n_head]
        for a, b in zip(before, after):
            af = a.float()
            want = (af - lr * (opt_cfg.weight_decay * af)).to(a.dtype)
            check(torch.equal(b, want), "(w) a leaf before the boundary "
                  "took another update than weight decay alone")
            moved += int((b != a).sum())
    launches = dict(_build.LAUNCHES)
    RUN_SIZES["w"] = dict(SIZE_LAUNCHES)
    check(launches["clip_quant"] == CODEC_STEPS
          and sum(launches.values()) == CODEC_STEPS,
          f"(w) launches {launches}: want clip_quant once a step")
    check(all(np.isfinite(losses)) and all(0 < r < 3 for r in rates),
          f"(w) losses {losses}, rates {rates}")
    n_before = sum(p.numel() for path, p in leaves(params)
                   if path[0] == "layers" and path[1] < n_head)
    print(f"(w) codec N=4 at the boundary after {n_head} of "
          f"{cfg.num_layers} layers, remat: loss {losses[0]:.4f} -> "
          f"{losses[-1]:.4f}; codec_rate_bits "
          + ", ".join(f"{r:.4f}" for r in rates)
          + f"; clip_quant launches {launches['clip_quant']} in "
          f"{CODEC_STEPS} steps; step {statistics.median(times[1:]) * 1e3:.1f} "
          f"ms (median of steps 1-{CODEC_STEPS - 1}); the {n_before} "
          "values before the boundary: zero gradient, decay-only update "
          f"exact, {moved} values changed in bf16")
    return {"launches": launches, "rates": rates, "losses": losses,
            "step_ms": statistics.median(times[1:]) * 1e3,
            "moved": moved, "values_before": n_before}


def train_resume(root: Path, dev) -> dict:
    """(x): at the smoke size, a failure at step 5 after the step-4
    checkpoint, then a resume; final parameters against the
    uninterrupted run's within rtol = atol = 1e-6."""
    import dataclasses

    from repro_torch.configs import get_config, reduced
    from repro_torch.data import DataConfig
    from repro_torch.train import Trainer, TrainerConfig
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.tree import leaves

    cfg = dataclasses.replace(reduced(get_config(TRAIN_ARCH)), vocab_size=256)
    dcfg = DataConfig(vocab_size=256, batch=8, seq_len=32)

    def trainer(d, **kw):
        return Trainer(cfg, TrainerConfig(steps=8, ckpt_every=4,
                                          ckpt_dir=str(root / d),
                                          warmup_steps=2), dcfg,
                       device=dev, **kw)

    full = trainer("x_full").run(resume=False)
    try:
        trainer("x_crash", fail_at_step=5).run(resume=False)
        raise AssertionError("(x) the injected failure did not raise")
    except RuntimeError as err:
        check("injected failure" in str(err), f"(x) {err}")
    check(ckpt.latest_step(str(root / "x_crash")) == 4,
          "(x) no step-4 checkpoint")
    resumed = trainer("x_crash").run(resume=True)
    worst, ok = 0.0, True
    for (_, a), (_, b) in zip(leaves(full["params"]),
                              leaves(resumed["params"])):
        a64, b64 = a.double(), b.double()
        worst = max(worst, float((a64 - b64).abs().max()))
        ok &= bool(torch.allclose(b64, a64, rtol=1e-6, atol=1e-6))
    check(ok, f"(x) resumed parameters differ: max |diff| {worst:.3e}")
    print(f"(x) {cfg.name} vocab 256: failure at step 5, resumed from the "
          f"step-4 checkpoint; max |diff| of the final parameters "
          f"{worst:.3e} (tolerance rtol = atol = 1e-6)")
    return {"max_abs_diff": worst}


def train_card_vs_cpu(cfg, dev) -> dict:
    """(y): ``loss_fn`` and the gradients' global norm on the card (bf16)
    against the port's float32 CPU run of the same weights, one batch of
    1 x 128."""
    import dataclasses

    from repro_torch.data import DataConfig, stream
    from repro_torch.models import init_params, loss_and_grads
    from repro_torch.optim import global_norm
    from repro_torch.tree import tree_map

    gen = torch.Generator(device=dev).manual_seed(0)
    params = init_params(cfg, gen, device=dev)
    tokens = next(stream(DataConfig(vocab_size=cfg.vocab_size, batch=1,
                                    seq_len=128)))["tokens"]
    (loss_c, _), g = loss_and_grads(cfg, params, torch.as_tensor(
        tokens, device=dev), remat=False)
    gn_c = float(global_norm(g))
    loss_c = float(loss_c)
    del g
    cpu = tree_map(lambda t: t.float().cpu(), params)
    del params
    t0 = time.perf_counter()
    (loss_h, _), g = loss_and_grads(dataclasses.replace(cfg, dtype="float32"),
                                    cpu, torch.as_tensor(tokens), remat=False)
    gn_h = float(global_norm(g))
    loss_h = float(loss_h)
    cpu_s = time.perf_counter() - t0
    rel_l, rel_g = abs(loss_c - loss_h) / abs(loss_h), abs(gn_c - gn_h) / gn_h
    check(rel_l <= TRAIN_LOSS_RTOL and rel_g <= TRAIN_GNORM_RTOL,
          f"(y) card against CPU: loss {loss_c} vs {loss_h}, grad norm "
          f"{gn_c} vs {gn_h}")
    print(f"(y) 1 x 128 tokens: loss {loss_c:.5f} (card, bf16) against "
          f"{loss_h:.5f} (CPU, float32), rel {rel_l:.2e} (tolerance "
          f"{TRAIN_LOSS_RTOL}); grad norm {gn_c:.5f} against {gn_h:.5f}, rel "
          f"{rel_g:.2e} (tolerance {TRAIN_GNORM_RTOL}); CPU run {cpu_s:.1f} s")
    return {"loss": [loss_c, loss_h], "grad_norm": [gn_c, gn_h]}


def train_cli(root: Path) -> dict:
    """(z): the training CLI at the reduced size with 4-bit gradient
    compression, in a subprocess."""
    env = dict(os.environ, PYTHONPATH=str(SRC))
    t0 = time.perf_counter()
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         TRAIN_ARCH, "--steps", "4", "--grad-compress-bits", "4",
         "--ckpt-dir", str(root / "z")], capture_output=True, text=True,
        timeout=600, env=env, cwd=ROOT)
    check(out.returncode == 0 and "final loss:" in out.stdout,
          f"(z) the CLI failed ({out.returncode}):\n{out.stdout}\n"
          f"{out.stderr[-3000:]}")
    final = [ln for ln in out.stdout.splitlines() if "final loss" in ln][0]
    print(f"(z) python -m repro_torch.launch.train --arch {TRAIN_ARCH} "
          f"--steps 4 --grad-compress-bits 4: {final} "
          f"({time.perf_counter() - t0:.1f} s)")
    return {"final": final}


def train_phase(dev) -> dict:
    """Phase 8: training gemma3-1b at published width and full depth
    (bf16, random weights from seed 0, the repo's token stream, batch
    TRAIN_BATCH x TRAIN_SEQ, AdamW defaults, warmup 2): (u) plain, (v)
    gradient compression, (w) the codec in the loop, (x) resume at the
    smoke size, (y) card against CPU, (z) the CLI.  Returns the runs'
    numbers."""
    import gc
    import shutil

    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig

    t0 = time.perf_counter()
    cfg = get_config(TRAIN_ARCH)
    dcfg = DataConfig(vocab_size=cfg.vocab_size, batch=TRAIN_BATCH,
                      seq_len=TRAIN_SEQ)
    root = ROOT / "build" / "train_phase"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    out = {}
    try:
        for run_id, run in (("u", lambda: train_plain(cfg, dcfg, root, dev)),
                            ("v", lambda: train_compressed(cfg, dcfg, root,
                                                           dev)),
                            ("w", lambda: train_codec(cfg, dcfg, dev)),
                            ("x", lambda: train_resume(root, dev)),
                            ("y", lambda: train_card_vs_cpu(cfg, dev)),
                            ("z", lambda: train_cli(root))):
            gc.collect()
            torch.cuda.empty_cache()
            out[run_id] = run()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    print(f"(v) step {out['v']['step_ms']:.1f} ms against (u)'s "
          f"{out['u']['step_ms']:.1f}; (w) {out['w']['step_ms']:.1f} ms")
    print(f"train phase: {time.perf_counter() - t0:.1f} s wall")
    return out


# -- phase 9: the dry run against the card -------------------------------------

# (arch, InputShape fields, config overrides): steps the card runs in
# phases 8 and 4 -- (u)'s batch, and the serve runs' prefill and decode
# (the engine's cache of 64 + 8 + 8 positions) -- and an RWKV-6 train
# step, whose time loop the meta pass counts a step at a time over 40
# tokens padded to three chunks
DRY_CELLS = (("gemma3-1b", ("train_8x256", 256, 8, "train"), {}),
             ("codeqwen1.5-7b", ("prefill_4x64", 64, 4, "prefill"), {}),
             ("codeqwen1.5-7b", ("decode_4x80", 80, 4, "decode"), {}),
             ("rwkv6-3b", ("train_2x40", 40, 2, "train"), {"num_layers": 4}))
DRY_REPS = 7
DRY_PEAK_RTOL = 0.10        # max_memory_allocated against the estimate


def dry_cell(arch: str, shape, overrides: dict, smi: str, dev) -> None:
    """One cell of phase 9: ``run_cell`` on the one-card mesh (meta
    device), then the same step on the card -- its FLOPs under
    ``FlopCounterMode`` and the bytes of its arguments must equal the
    meta pass's, its peak memory the estimate within DRY_PEAK_RTOL; its
    median time over DRY_REPS runs between syncs beside the eager
    roofline."""
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.configs import get_config
    from repro_torch.kernels import _build
    from repro_torch.launch import dryrun
    from repro_torch.launch.dryrun import H100
    from repro_torch.launch.mesh import make_smoke_mesh

    cfg = dataclasses.replace(get_config(arch), **overrides)
    rec = dryrun.run_cell(arch, shape, mesh=make_smoke_mesh(1),
                          microbatches=1, save_ops=False,
                          overrides=overrides)
    check(rec["status"] == "ok", f"(9) {arch} {shape.name}: "
          f"{rec.get('traceback', rec.get('reason'))}")
    ops, rl = rec["ops"], rec["roofline"]
    lb_ms = rl["step_time_lower_bound_s"] * 1e3
    print(f"(9) {arch} {shape.name} {overrides or ''} predicted (meta "
          f"pass {rec['trace_s']} s): model FLOPs "
          f"{rec['model_flops_global']:.4e}, counted FLOPs "
          f"{ops['flops']:.4e}, eager traffic {ops['traffic_bytes']:.4e} "
          f"B, eager roofline {lb_ms:.3f} ms ({rl['bound']}-bound: "
          f"compute {rl['compute_s'] * 1e3:.3f} ms, memory "
          f"{rl['memory_s'] * 1e3:.3f} ms)")

    gen = torch.Generator(device=dev).manual_seed(0)
    step, args = dryrun.cell_step(cfg, shape, 1, device=dev, generator=gen)
    held = sum(t.numel() * t.element_size() for t in _leaves(list(args))
               if isinstance(t, torch.Tensor))
    check(held == rec["memory"]["argument_bytes"], f"(9) {arch} "
          f"{shape.name}: {held} argument bytes on the card, predicted "
          f"{rec['memory']['argument_bytes']}")
    _build.reset_launches()
    with FlopCounterMode(display=False) as fc:
        step(*args)
    torch.cuda.synchronize()
    # FlopCounterMode sees neither attention kernel: add the products the
    # meta pass counts as the plain path's two matmuls -- #10's 4 * B * H
    # * n_valid * hd a launch (a decode cell's pos is its last slot, so
    # n_valid is the whole cache), #11's 4 * B * H * S * S * hd over the
    # whole square a launch
    card_flops = fc.get_total_flops() + (
        _build.LAUNCHES["decode_attention"]
        + _build.LAUNCHES["prefill_attention"] * shape.seq_len) \
        * 4 * shape.global_batch * cfg.num_heads * shape.seq_len \
        * cfg.head_dim
    check(card_flops == ops["flops"], f"(9) {arch} {shape.name}: "
          f"FlopCounterMode counts {card_flops} FLOPs on the card, the "
          f"meta pass {ops['flops']}")
    step(*args)                               # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(DRY_REPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(*args)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    ms = statistics.median(times) * 1e3
    peak = torch.cuda.max_memory_allocated()
    est = rec["memory"]["peak_bytes_est"]
    mfu = rec["model_flops_global"] / (ms / 1e3 * H100["peak_flops"])
    print(f"(9) {arch} {shape.name} measured: {ms:.2f} ms (median of "
          f"{DRY_REPS} between syncs) / eager roofline {lb_ms:.3f} ms = "
          f"{ms / lb_ms:.1f}x; model-FLOPs share {mfu:.4f}; FLOPs on the "
          f"card {card_flops} = the meta pass's; arguments {held} B = "
          f"predicted; peak {peak / 1e9:.2f} GB "
          f"(torch.cuda.max_memory_allocated) against the estimate "
          f"{est / 1e9:.2f} GB ({peak / est - 1:+.4f}); {smi}")
    check(abs(peak - est) <= DRY_PEAK_RTOL * est, f"(9) {arch} "
          f"{shape.name}: peak {peak} B on the card, estimated {est} B, "
          f"not within {DRY_PEAK_RTOL:.0%}")


def dryrun_phase(smi: str, dev) -> None:
    """Phase 9: the dry run's prediction of each of DRY_CELLS against the
    same step on the card."""
    import gc

    from repro_torch.configs import InputShape

    t0 = time.perf_counter()
    for arch, fields, overrides in DRY_CELLS:
        gc.collect()
        torch.cuda.empty_cache()
        dry_cell(arch, InputShape(*fields), overrides, smi, dev)
    print(f"dry-run phase: {time.perf_counter() - t0:.1f} s wall")


# -- phase 10: the multi-device path ---------------------------------------------

EP_ARCH, EP_LAYERS = "qwen3-moe-235b-a22b", 2        # 2 of its 94 layers
EP_BATCH, EP_PROMPT, EP_DECODES = 2, 64, 8
EP_MAX_SEQ = EP_PROMPT + EP_DECODES + 8
# the train step's further cut: AdamW holds 12 bytes a parameter, twice
# during the update, so two ranks of the serving model (each 64 experts a
# layer and the 151,936-token embedding and head) need ~2 x 46 GB, more
# than the card; the step keeps every width but these two
EP_TRAIN_CUT = {"num_experts": 32, "vocab_size": 8192}
EP_TRAIN_BATCH, EP_TRAIN_SEQ = 2, 64
# the layer output on each boundary against moe_local: bf16 expert FFNs
# whose matmuls run at another batch shape, so up to 8 bf16 units of
# roundoff (2^-8) of the output's largest magnitude
EP_LAYER_TOL = 2.0 ** -5
EP_GNORM_RTOL = 1e-3       # the step's global norm, gradients recomputed
EP_REPS = 5
EP_TIMEOUT_S = 600
SPLIT_FAMILIES = (("qwen3-moe-235b-a22b", {"num_layers": EP_LAYERS}),
                  ("rwkv6-3b", {}))
FAMILY_PROMPT, FAMILY_NEW = 4, 4           # 8 decode steps a run


def ep_config():
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config(EP_ARCH), num_layers=EP_LAYERS)


def ep_inputs(cfg, dev) -> dict:
    """The phase's seeded inputs, the same on every rank: the prefill and
    decode boundaries of one MoE layer, the engine's prompts."""
    gen = torch.Generator(device=dev).manual_seed(7)
    prompts = np.random.default_rng(7).integers(
        0, cfg.vocab_size, (EP_BATCH, EP_PROMPT)).astype(np.int32)
    return {"prefill": torch.randn((EP_BATCH, EP_PROMPT, cfg.d_model),
                                   generator=gen, device=dev,
                                   dtype=torch.bfloat16),
            "decode": torch.randn((EP_BATCH, 1, cfg.d_model), generator=gen,
                                  device=dev, dtype=torch.bfloat16),
            "prompts": prompts}


def layer_ms(fn) -> float:
    """Median wall ms of ``fn`` between device syncs, after a warm-up."""
    fn()
    times = []
    for _ in range(EP_REPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def engine_run(cfg, params, prompts, dev, ctx=None) -> dict:
    """Greedy generation through ``ServeEngine`` (one prefill of the
    prompts, then EP_DECODES decode steps), the logits of every step
    recorded."""
    from repro_torch.serving import Request, ServeEngine

    eng = ServeEngine(cfg, params, slots=EP_BATCH, max_seq=EP_MAX_SEQ,
                      ctx=ctx, device=dev)
    logits = []
    prefill, decode = eng._prefill, eng._decode

    def rec_prefill(p, t, c, *, split):
        lg, c = prefill(p, t, c, split=split)
        logits.append(lg.float().cpu())
        return lg, c

    def rec_decode(p, t, c, pos, *, split):
        lg, c, aux = decode(p, t, c, pos, split=split)
        logits.append(lg.float().cpu())
        return lg, c, aux

    eng._prefill, eng._decode = rec_prefill, rec_decode
    reqs = [Request(prompt=pr, max_new_tokens=EP_DECODES + 1)
            for pr in prompts]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng.generate(reqs)
    torch.cuda.synchronize()
    return {"logits": torch.stack(logits),
            "tokens": torch.tensor([r.out_tokens for r in reqs]),
            "s": time.perf_counter() - t0}


def _rank_tree_digest(tree) -> dict:
    """sha256 of the bytes of each replicated (non-expert) leaf."""
    import hashlib

    from repro_torch.models.context import is_expert_leaf
    from repro_torch.tree import leaves
    return {"/".join(map(str, path)): hashlib.sha256(
        t.detach().contiguous().view(torch.uint8).cpu().numpy().tobytes())
        .hexdigest() for path, t in leaves(tree) if not is_expert_leaf(path)}


def ep_rank(rank: int, init: str, out_dir: str) -> None:
    """One of the two expert-parallel ranks of (aa), both on cuda:0 in a
    (data, model) = (1, 2) mesh over gloo: this rank keeps its 64 experts
    a layer.  Writes its numbers, logits and digests to ``out_dir``."""
    import datetime
    import gc

    import torch.distributed as dist

    from repro_torch.launch.mesh import Mesh, device_mesh
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import (DistContext, init_params, loss_and_grads,
                                    shard_experts)
    from repro_torch.models import context as C
    from repro_torch.models import moe as MOE
    from repro_torch.optim import global_norm, init_opt_state

    torch.cuda.set_device(0)
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    dist.init_process_group("gloo", init_method=f"file://{init}", rank=rank,
                            world_size=2,
                            timeout=datetime.timedelta(seconds=300))
    out = {"rank": rank, "backend": dist.get_backend()}
    try:
        ctx = DistContext(device_mesh(Mesh((1, 2), ("data", "model")),
                                      "cuda"))
        out["tp_rank"] = ctx.tp_rank
        cfg = ep_config()
        full = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                           device=dev)
        whole0 = full["layers"][0]["moe"]         # all 128 experts
        params = shard_experts(cfg, full, ctx)
        del full
        inp = ep_inputs(cfg, dev)
        mine = params["layers"][0]["moe"]
        e, k = cfg.num_experts, cfg.experts_per_token
        with torch.inference_mode():
            # (1) the prefill boundary: this rank's chunk of the sequence
            # path against moe_local of that chunk at its capacity
            x = inp["prefill"]
            ep = MOE.moe_apply(x, mine, cfg, ctx)
            n = EP_PROMPT // 2
            chunk = x[:, rank * n:(rank + 1) * n].reshape(-1, cfg.d_model)
            cap = MOE._capacity(chunk.shape[0], k, e, cfg.capacity_factor)
            ref = MOE.moe_local(chunk, whole0, cfg, cap=cap)
            got = ep[:, rank * n:(rank + 1) * n].reshape(-1, cfg.d_model)
            out["prefill_err"] = float((got.float() - ref.float()).abs().max())
            out["prefill_scale"] = float(ref.float().abs().max())
            out["prefill_exact"] = float((got == ref).float().mean())
            out["prefill_cap"] = cap
            # (2) the decode boundary: all tokens on every rank, partial
            # sums across the ranks, against moe_local at the whole t
            x = inp["decode"]
            ep = MOE.moe_apply(x, mine, cfg, ctx).reshape(-1, cfg.d_model)
            ref = MOE.moe_local(x.reshape(-1, cfg.d_model), whole0, cfg)
            out["decode_err"] = float((ep.float() - ref.float()).abs().max())
            out["decode_scale"] = float(ref.float().abs().max())
            out["prefill_ms"] = layer_ms(
                lambda: MOE.moe_apply(inp["prefill"], mine, cfg, ctx))
            out["decode_ms"] = layer_ms(
                lambda: MOE.moe_apply(inp["decode"], mine, cfg, ctx))
        del whole0, ep, ref
        gc.collect()
        torch.cuda.empty_cache()
        # (3) the engine: prefill and greedy decode steps, logits recorded
        torch.cuda.reset_peak_memory_stats()
        run = engine_run(cfg, params, inp["prompts"], dev, ctx)
        out["peak_bytes"] = torch.cuda.max_memory_allocated()
        out["param_bytes"] = sum(t.numel() * t.element_size()
                                 for t in _leaves(params))
        out["engine_s"] = run["s"]
        torch.save({"logits": run["logits"], "tokens": run["tokens"]},
                   os.path.join(out_dir, f"ep_rank{rank}.pt"))
        del params, run
        gc.collect()
        torch.cuda.empty_cache()
        # (4) one train step at EP_TRAIN_BATCH x EP_TRAIN_SEQ (the model cut
        # further, EP_TRAIN_CUT): the global norm of the gradients
        # gathered whole, then the step itself
        torch.cuda.reset_peak_memory_stats()
        tcfg = dataclasses.replace(cfg, **EP_TRAIN_CUT)
        tparams = shard_experts(tcfg, init_params(
            tcfg, torch.Generator(device=dev).manual_seed(0), device=dev),
            ctx)
        tokens = torch.as_tensor(np.random.default_rng(8).integers(
            0, tcfg.vocab_size, (EP_TRAIN_BATCH, EP_TRAIN_SEQ)), device=dev)
        (_, _), grads = loss_and_grads(tcfg, tparams, tokens, ctx=ctx)
        whole = C.gather_experts(C.average_grads(grads, ctx), ctx)
        out["gathered_norm"] = float(global_norm(whole))
        del grads, whole
        gc.collect()
        step = make_train_step(tcfg, ctx=ctx)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        new_p, _, m = step(tparams, init_opt_state(tparams),
                           {"tokens": tokens})
        torch.cuda.synchronize()
        out["step_s"] = time.perf_counter() - t0
        out["loss"] = float(m["loss"])
        out["loss_bits"] = m["loss"].float().cpu().numpy().tobytes().hex()
        out["grad_norm"] = float(m["grad_norm"])
        out["digests"] = _rank_tree_digest(new_p)
        out["train_peak_bytes"] = torch.cuda.max_memory_allocated()
        dist.barrier()
    finally:
        dist.destroy_process_group()
    with open(os.path.join(out_dir, f"ep_rank{rank}.json"), "w") as f:
        json.dump(out, f)


def ep_one_rank(cfg, params, inp, dev) -> dict:
    """The one-rank model of (aa): the engine run and the MoE layer on
    both boundaries with all 128 experts on one process."""
    from repro_torch.models import moe as MOE

    whole0 = params["layers"][0]["moe"]
    with torch.inference_mode():
        prefill_ms = layer_ms(lambda: MOE.moe_apply(inp["prefill"], whole0,
                                                    cfg))
        decode_ms = layer_ms(lambda: MOE.moe_apply(inp["decode"], whole0,
                                                   cfg))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    run = engine_run(cfg, params, inp["prompts"], dev)
    return {**run, "peak_bytes": torch.cuda.max_memory_allocated(),
            "param_bytes": sum(t.numel() * t.element_size()
                               for t in _leaves(params)),
            "prefill_ms": prefill_ms, "decode_ms": decode_ms}


def family_split(arch: str, overrides: dict, dev, params=None) -> dict:
    """(ab) on one arch at published width: the packed split runtime, split
    half + half, 8 decode steps of EP_BATCH sequences each in ``raw`` and
    ``packed`` (per-tensor N=4, calibrated in "model" mode): ``raw`` equal
    to the unsplit decode step rounded through bfloat16, ``packed``
    launching the per-tensor quantizer once a step and never the pack
    kernel or a histogram.  Returns the packed run's tokens fed, logits
    and codec (what (ae) holds its ranks to)."""
    from repro_torch.compression import split_runtime as SR
    from repro_torch.configs import get_config
    from repro_torch.core import CodecConfig, calibrate
    from repro_torch.kernels import _build
    from repro_torch.launch import serve as S
    from repro_torch.models import decode_step, init_cache, init_params

    t0 = time.perf_counter()
    cfg = dataclasses.replace(get_config(arch), **overrides)
    if params is None:
        params = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                             device=dev)
    half, tail = SR.stage_layout(cfg)
    sp = SR.split_params(cfg, params, edge_device=dev, cloud_device=dev)
    samples = S.warmup_samples(cfg, params, batches=WARMUP_BATCHES,
                               seq_len=32, device=dev, split_after=half)
    codec = calibrate(CodecConfig(n_levels=N_SERVE, clip_mode="model",
                                  constrain_cmin_zero=False, backend="cuda"),
                      samples=samples.reshape(-1))
    prompt = torch.as_tensor(np.random.default_rng(2).integers(
        0, cfg.vocab_size, (EP_BATCH, FAMILY_PROMPT)), device=dev)
    steps = FAMILY_PROMPT + FAMILY_NEW
    max_seq = steps + 8

    def unsplit_step(params_, tok, cache_, pos):
        with torch.inference_mode():
            logits, cache_, _ = decode_step(cfg, params_, tok, cache_, pos)
        return logits.to(torch.bfloat16).to(torch.float32), cache_, 0.0

    ref_logits, ref_tok, _, _ = split_decode(
        unsplit_step, params, init_cache(cfg, EP_BATCH, max_seq, device=dev),
        prompt, FAMILY_PROMPT, FAMILY_NEW)
    out = {}
    for transport in ("raw", "packed"):
        step = SR.make_split_decode_step(
            cfg, None if transport == "raw" else codec, transport=transport,
            edge_device=dev, cloud_device=dev)
        caches = SR.init_split_cache(cfg, EP_BATCH, max_seq, edge_device=dev,
                                     cloud_device=dev)
        _build.reset_launches()
        logits, toks, rate, dt = split_decode(step, sp, caches, prompt,
                                              FAMILY_PROMPT, FAMILY_NEW)
        counts = dict(_build.LAUNCHES)
        check(bool(torch.isfinite(logits).all()), f"(ab) {arch} {transport}:"
              " logits not finite")
        out[transport] = (logits, toks)
        if transport == "packed":
            packed = {"inputs": fed_tokens(prompt, toks).cpu(),
                      "logits": logits.cpu(), "codec": codec}
        print(f"(ab) {arch} split {half} + {half + tail} {transport}: "
              f"{steps} steps in {dt:.2f} s, rate {rate:.4f} bits/element, "
              f"launches {json.dumps({k: v for k, v in counts.items() if v})}"
              f", greedy tokens agree with the unsplit decode "
              f"{float((toks == ref_tok).float().mean()):.3f}")
        if transport == "packed":
            check(counts["clip_quant"] == steps and counts["pack_bits"] == 0
                  and counts["index_histogram"] == 0,
                  f"(ab) {arch} packed: launches {counts} (want clip_quant "
                  f"{steps}, pack_bits 0, index_histogram 0)")
    diff = float((out["raw"][0] - ref_logits).abs().max())
    check(diff == 0 and torch.equal(out["raw"][1], ref_tok),
          f"(ab) {arch} raw differs from the unsplit decode step rounded "
          f"through bfloat16 by {diff}")
    print(f"(ab) {arch}: raw equals the unsplit decode step rounded through "
          f"bfloat16 (largest logit difference {diff}); packed launched the "
          f"per-tensor quantizer once a step, no pack, no histogram "
          f"({time.perf_counter() - t0:.1f} s)")
    return packed


def train_cli_distributed() -> None:
    """(ac): ``launch.train --distributed`` under torchrun, NCCL, a world of
    one rank on the card."""
    t0 = time.perf_counter()
    ckpt = ROOT / "build" / "train_cli_distributed"
    env = dict(os.environ, PYTHONPATH=str(SRC))
    res = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node", "1", "-m", "repro_torch.launch.train",
         "--distributed", "--arch", TRAIN_ARCH, "--steps", "2", "--device",
         "cuda", "--ckpt-dir", str(ckpt)], capture_output=True, text=True,
        timeout=600, env=env)
    import shutil
    shutil.rmtree(ckpt, ignore_errors=True)
    check(res.returncode == 0, f"(ac) torchrun exited {res.returncode}:\n"
          f"{res.stdout[-2000:]}\n{res.stderr[-3000:]}")
    head = "distributed: rank 0 of 1, backend nccl, device cuda:0"
    check(head in res.stdout and "final loss:" in res.stdout,
          f"(ac) unexpected output:\n{res.stdout[-2000:]}")
    final = res.stdout.strip().splitlines()[-1]
    print(f"(ac) python -m torch.distributed.run --standalone "
          f"--nproc_per_node 1 -m repro_torch.launch.train --distributed "
          f"--arch {TRAIN_ARCH} --steps 2 --device cuda: {head}; {final} "
          f"({time.perf_counter() - t0:.1f} s)")


def distributed_phase(smi: str, dev) -> tuple[dict, list]:
    """Phase 10: (aa) expert parallelism on two ranks on the one card,
    (ab) the packed split runtime on qwen3-moe-235b-a22b and rwkv6-3b,
    (ag) the engine's slots over two dp ranks, (ac) the training CLI
    under torchrun.  Returns (ab)'s packed run on qwen3-moe-235b-a22b and
    (ag)'s launches per rank."""
    import gc
    import tempfile

    from repro_torch.models import init_params

    t0 = time.perf_counter()
    cfg = ep_config()
    gc.collect()
    torch.cuda.empty_cache()
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                         device=dev)
    inp = ep_inputs(cfg, dev)
    one = ep_one_rank(cfg, params, inp, dev)
    # (ab) on the same weights first, then the model is freed
    moe_split = family_split(*SPLIT_FAMILIES[0], dev, params=params)
    del params
    gc.collect()
    torch.cuda.empty_cache()

    # (aa) two ranks on cuda:0 over gloo: NCCL refuses two ranks on one
    # card ("Duplicate GPU detected"); gloo stages the card's tensors
    # through the host, so the collective times are not a link's
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        spawned(ep_rank, 2, (os.path.join(tmp, "pg"), tmp), "aa",
                EP_TIMEOUT_S)
        ranks = []
        for r in range(2):
            with open(os.path.join(tmp, f"ep_rank{r}.json")) as f:
                ranks.append(json.load(f))
            ranks[-1].update(torch.load(os.path.join(tmp, f"ep_rank{r}.pt")))
    a, b = ranks
    print(f"(aa) {EP_ARCH} at published width, {EP_LAYERS} of 94 layers, "
          f"bf16, expert-parallel over 2 ranks on one card, process group "
          f"{a['backend']} (collectives staged through the host: not a "
          f"link measurement); {smi}")
    for r in ranks:
        for side in ("prefill", "decode"):
            err, scale = r[f"{side}_err"], r[f"{side}_scale"]
            check(err <= EP_LAYER_TOL * scale, f"(aa) rank {r['rank']} "
                  f"{side} boundary: layer output {err} from moe_local, "
                  f"tolerance {EP_LAYER_TOL * scale}")
        print(f"(aa) rank {r['rank']}: layer output on the prefill boundary "
              f"({EP_BATCH}, {EP_PROMPT}), its chunk at capacity "
              f"{r['prefill_cap']}: largest difference from moe_local "
              f"{r['prefill_err']} (largest output {r['prefill_scale']}, "
              f"{r['prefill_exact']:.4f} of elements equal); decode boundary "
              f"({EP_BATCH}, 1): {r['decode_err']} (largest output "
              f"{r['decode_scale']}); ms per EP layer: prefill "
              f"{r['prefill_ms']:.3f}, decode {r['decode_ms']:.3f} (one rank, "
              f"all 128 experts, moe_local: {one['prefill_ms']:.3f}, "
              f"{one['decode_ms']:.3f})")
    check(torch.equal(a["logits"], b["logits"])
          and torch.equal(a["tokens"], b["tokens"]),
          "(aa) the two ranks' engine logits or tokens differ")
    check(a["logits"].shape[0] == 1 + EP_DECODES
          and bool(torch.isfinite(a["logits"]).all()),
          f"(aa) engine logits {tuple(a['logits'].shape)}")
    diff = float((a["logits"] - one["logits"]).abs().max())
    agree = float((a["tokens"] == one["tokens"]).float().mean())
    print(f"(aa) ServeEngine(ctx=...): prefill + {EP_DECODES} greedy decode "
          f"steps, logits identical in every bit on both ranks, tokens "
          f"identical; against the one-rank model (capacity over the whole "
          f"batch, not per chunk): largest logit difference {diff}, tokens "
          f"agree {agree:.3f}; engine {a['engine_s']:.2f} s (one rank "
          f"{one['s']:.2f} s)")
    print(f"(aa) peak device memory (torch.cuda.max_memory_allocated) over "
          f"the engine run: rank 0 {a['peak_bytes'] / 1e9:.2f} GB, rank 1 "
          f"{b['peak_bytes'] / 1e9:.2f} GB (parameters "
          f"{a['param_bytes'] / 1e9:.2f} GB a rank); one-rank model "
          f"{one['peak_bytes'] / 1e9:.2f} GB (parameters "
          f"{one['param_bytes'] / 1e9:.2f} GB)")
    check(a["loss_bits"] == b["loss_bits"],
          f"(aa) train step losses differ: {a['loss']} / {b['loss']}")
    check(a["digests"] == b["digests"],
          "(aa) replicated leaves differ between the ranks after the step: "
          + ", ".join(k for k in a["digests"]
                      if a["digests"][k] != b["digests"].get(k)))
    for r in ranks:
        rel = abs(r["grad_norm"] - r["gathered_norm"]) / r["gathered_norm"]
        check(rel <= EP_GNORM_RTOL, f"(aa) rank {r['rank']}: step global "
              f"norm {r['grad_norm']} against the gathered gradients' "
              f"{r['gathered_norm']} (rel {rel})")
    print(f"(aa) make_train_step(ctx=...) at {EP_TRAIN_BATCH} x "
          f"{EP_TRAIN_SEQ}, the model cut further to {EP_TRAIN_CUT}: loss "
          f"{a['loss']} identical on both ranks, {len(a['digests'])} "
          f"replicated leaves identical in every bit after the step; global "
          f"norm {a['grad_norm']} against {a['gathered_norm']} of the "
          f"gradients gathered whole (rank 1: {b['grad_norm']} / "
          f"{b['gathered_norm']}); step {a['step_s']:.2f} s; peak "
          f"{a['train_peak_bytes'] / 1e9:.2f} / "
          f"{b['train_peak_bytes'] / 1e9:.2f} GB")

    # (ab) the recurrent arch at published width and depth
    gc.collect()
    torch.cuda.empty_cache()
    family_split(*SPLIT_FAMILIES[1], dev)
    gc.collect()
    torch.cuda.empty_cache()
    # (ag) the engine's slots over a data axis of two ranks
    dp_launches = dp_engine_phase(smi, dev)
    gc.collect()
    torch.cuda.empty_cache()
    # (ac)
    train_cli_distributed()
    print(f"distributed phase: {time.perf_counter() - t0:.1f} s wall")
    return moe_split, dp_launches


# (ag): codeqwen1.5-7b at published width cut to 2 layers (the codec's
# boundary after the first), 4 slots, 8 ragged requests (prompt length,
# new tokens): epochs and mid-epoch refills
DP_LAYERS, DP_SLOTS, DP_MAX_SEQ = 2, 4, 64
DP_REQUESTS = ((24, 6), (16, 10), (32, 4), (20, 8), (12, 6), (28, 5),
               (16, 9), (8, 7))


def dp_engine_run(cfg, params, codec, dev, ctx=None) -> dict:
    """``ServeEngine(codec=)`` on DP_REQUESTS (seeded prompts), each step
    timed between device syncs: tokens, ``rate_log``, counters (latency
    percentiles aside), retirements, the median ms of a decode step and
    the launches."""
    from repro_torch.kernels import _build
    from repro_torch.serving import Request, ServeEngine

    eng = ServeEngine(cfg, params, slots=DP_SLOTS, max_seq=DP_MAX_SEQ,
                      ctx=ctx, codec=codec, device=dev)
    rng = np.random.default_rng(9)
    reqs = [Request(prompt=rng.integers(0, cfg.vocab_size, p)
                    .astype(np.int32), max_new_tokens=n)
            for p, n in DP_REQUESTS]
    decode_ms = []
    run = eng._run

    def timed(fn, *args):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = run(fn, *args)
        torch.cuda.synchronize()
        if fn is eng._decode:
            decode_ms.append((time.perf_counter() - t0) * 1e3)
        return out

    eng._run = timed
    _build.reset_launches()
    t0 = time.perf_counter()
    eng.generate(reqs)
    return {"tokens": [r.out_tokens for r in reqs],
            "rate_log": [float(r) for r in eng.rate_log],
            "counters": {k: v for k, v in eng.counters.items()
                         if "latency" not in k},
            "retired": [[d["slot"], d["prompt_len"], d["new_tokens"]]
                        for d in eng.latency_log],
            "decode_ms": statistics.median(decode_ms),
            "decode_steps": len(decode_ms),
            "s": time.perf_counter() - t0,
            "launches": dict(_build.LAUNCHES)}


def dp_rank(rank: int, init: str, out_dir: str, codec) -> None:
    """One of (ag)'s two ranks on cuda:0, a (data, model) = (2, 1) mesh
    over gloo: the whole model from seed 0, the engine on its block of
    the slots."""
    import datetime

    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import Mesh, device_mesh
    from repro_torch.models import DistContext, init_params

    torch.cuda.set_device(0)
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group("gloo", init_method=f"file://{init}", rank=rank,
                            world_size=2,
                            timeout=datetime.timedelta(seconds=300))
    try:
        ctx = DistContext(device_mesh(Mesh((2, 1), ("data", "model")),
                                      "cuda"), ("data",))
        cfg = dataclasses.replace(get_config("codeqwen1.5-7b"),
                                  num_layers=DP_LAYERS)
        params = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                             device=dev)
        out = {"rank": rank, "dp_rank": ctx.dp_rank,
               **dp_engine_run(cfg, params, codec, dev, ctx)}
        dist.barrier()
    finally:
        dist.destroy_process_group()
    with open(os.path.join(out_dir, f"dp_rank{rank}.json"), "w") as f:
        json.dump(out, f)


def dp_engine_phase(smi: str, dev) -> list[dict]:
    """(ag): ``ServeEngine(ctx=)`` with its slots split over a data axis
    of two gloo ranks on this card, a per-tensor N=4 ``codec=``
    (calibrated in "model" mode from a warm-up batch): tokens,
    ``rate_log``, counters and retirements equal the one-rank engine's
    on both ranks.  Returns each rank's launch counts."""
    import tempfile

    from repro_torch.configs import get_config
    from repro_torch.core import CodecConfig, calibrate
    from repro_torch.launch import serve as S
    from repro_torch.models import init_params

    cfg = dataclasses.replace(get_config("codeqwen1.5-7b"),
                              num_layers=DP_LAYERS)
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                         device=dev)
    codec = calibrate(CodecConfig(
        n_levels=N_SERVE, clip_mode="model", constrain_cmin_zero=False,
        backend="cuda"), samples=S.warmup_samples(
            cfg, params, batches=1, seq_len=32, device=dev).reshape(-1))
    dp_engine_run(cfg, params, codec, dev)          # warm-up
    one = dp_engine_run(cfg, params, codec, dev)
    del params
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        spawned(dp_rank, 2, (os.path.join(tmp, "pg-ag"), tmp, codec), "ag")
        ranks = []
        for r in range(2):
            with open(os.path.join(tmp, f"dp_rank{r}.json")) as f:
                ranks.append(json.load(f))
    for r in ranks:
        for key in ("tokens", "rate_log", "counters", "retired"):
            check(r[key] == one[key], f"(ag) rank {r['rank']}: {key} "
                  "differ from the one-rank engine's")
    check(one["counters"]["refills"] > 0 and len(one["rate_log"]) > 0,
          f"(ag) counters {one['counters']}")
    print(f"(ag) ServeEngine(ctx=...) on a data axis of 2 (two gloo ranks on "
          f"one card, logits and index counts gathered through the host), "
          f"codeqwen1.5-7b at published width, {DP_LAYERS} layers, "
          f"{DP_SLOTS} slots, {len(DP_REQUESTS)} requests, per-tensor N="
          f"{N_SERVE} codec=: tokens, rate_log ({len(one['rate_log'])} "
          f"steps), counters and retirements equal to the one-rank engine's "
          f"on both ranks ({one['counters']['epochs']} epochs, "
          f"{one['counters']['refills']} refills); ms per decode step "
          f"(median over {one['decode_steps']}): rank 0 "
          f"{ranks[0]['decode_ms']:.3f}, rank 1 {ranks[1]['decode_ms']:.3f} "
          f"(one rank {one['decode_ms']:.3f}); engine s: "
          f"{ranks[0]['s']:.2f} / {ranks[1]['s']:.2f} (one rank "
          f"{one['s']:.2f}); launches a rank: " + json.dumps(
              {k: v for k, v in ranks[0]['launches'].items() if v})
          + f" (one rank: "
          + json.dumps({k: v for k, v in one['launches'].items() if v})
          + f"); {smi}")
    return [r["launches"] for r in ranks]


# -- phase 11: the split runtime across ranks ------------------------------------

RANKS_TIMEOUT_S = 600
# the parts of a step across ranks, each between two ends of make_split_
# decode_step's spans: (name, (rank, span, 0 start or 1 end) where it
# begins, the same where it ends)
STEP_PARTS = (("edge stage", ("edge", "edge_stage", 0),
               ("edge", "edge_stage", 1)),
              ("crossing", ("edge", "edge_stage", 1),
               ("cloud", "payload_recv", 1)),
              ("cloud stage", ("cloud", "cloud_stage", 0),
               ("cloud", "cloud_stage", 1)),
              ("return path", ("cloud", "cloud_stage", 1),
               ("edge", "logits_recv", 1)),
              ("step", ("edge", "edge_stage", 0), ("edge", "logits_recv", 1)))
# the same parts of the one-process step, which has no return path
ONE_PROCESS_PARTS = (STEP_PARTS[0],
                     ("crossing", ("edge", "edge_stage", 1),
                      ("edge", "crossing", 1)),
                     STEP_PARTS[2],
                     ("step", ("edge", "edge_stage", 0),
                      ("edge", "cloud_stage", 1)))


def split_rank(rank: int, world: int, init: str, out_dir: str,
               job: dict) -> None:
    """One rank of (ad) or (ae): a gloo process on cuda:0 in the (pod,
    data, model) mesh ``job["mesh"]``, holding its stage of the model.
    Runs each of ``job["runs"]`` through ``make_split_decode_step(...,
    ctx=...)`` on the tokens given and writes its logits, payloads and
    rates, each step's spans (:func:`traced_steps`), its launch counts
    and peak device memory."""
    import datetime
    import gc

    import torch.distributed as dist

    from repro_torch.compression import split_runtime as SR
    from repro_torch.configs import get_config
    from repro_torch.kernels import _build
    from repro_torch.launch.mesh import Mesh, device_mesh
    from repro_torch.models import DistContext

    torch.cuda.set_device(0)
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group("gloo", init_method=f"file://{init}", rank=rank,
                            world_size=world,
                            timeout=datetime.timedelta(seconds=300))
    out = {"rank": rank}
    try:
        ctx = DistContext(device_mesh(Mesh(job["mesh"], ("pod", "data",
                                                         "model")),
                                      "cuda"), ("data",))
        cfg = dataclasses.replace(get_config(job["arch"]), **job["overrides"])
        kw = dict(edge_device=dev, cloud_device=dev, ctx=ctx)
        # the one-process runs' weights: every rank draws the whole model
        # from seed 0 and keeps its stage -- one rank at a time where the
        # card cannot hold every rank's draw at once
        for turn in range(world) if job["in_turn"] else [rank]:
            if turn == rank:
                params = SR.init_split_params(
                    cfg, torch.Generator(device=dev).manual_seed(0), **kw)
                gc.collect()
                torch.cuda.empty_cache()
            if job["in_turn"]:
                dist.barrier()
        (out["stage"],) = params
        out["param_bytes"] = sum(t.numel() * t.element_size()
                                 for t in _leaves(params))
        for label, transport, codec, inputs in job["runs"]:
            sent: list = []         # the packed payloads the edge makes
            step = SR.make_split_decode_step(
                cfg, None if codec is None else link_counted(codec, [], [],
                                                             sent),
                transport=transport, **kw)
            caches = SR.init_split_cache(cfg, inputs.shape[1],
                                         job["max_seq"], **kw)
            toks = inputs.to(dev)
            logits_all, rates = [], []

            def run(pos, step=step, caches=caches, toks=toks,
                    logits_all=logits_all, rates=rates):
                logits, _, rate = step(params, toks[pos], caches, pos)
                logits_all.append(logits)
                rates.append(rate)

            torch.cuda.synchronize()
            _build.reset_launches()
            torch.cuda.reset_peak_memory_stats()
            spans = traced_steps(inputs.shape[0], run)
            torch.cuda.synchronize()
            out[label] = {"steps": spans, "launches": dict(_build.LAUNCHES),
                          "peak_bytes": torch.cuda.max_memory_allocated(),
                          "rates": [float(r) for r in rates]}
            torch.save({"logits": torch.stack(logits_all).cpu(),
                        "payloads": [t.cpu() for t in sent]},
                       os.path.join(out_dir, f"{label}_rank{rank}.pt"))
            del caches, step
        dist.barrier()
    finally:
        dist.destroy_process_group()
    with open(os.path.join(out_dir, f"{job['runs'][0][0]}_rank{rank}.json"),
              "w") as f:
        json.dump(out, f)


def spawned(fn, nprocs: int, args: tuple, label: str,
            timeout_s: float = RANKS_TIMEOUT_S) -> None:
    """Run ``fn(i, *args)`` in ``nprocs`` spawned processes; fails if one
    raises or they are not done within ``timeout_s``, and leaves none
    running."""
    import torch.multiprocessing as mp

    pc = mp.start_processes(fn, args=args, nprocs=nprocs, join=False,
                            start_method="spawn")
    deadline = time.monotonic() + timeout_s
    try:
        while not pc.join(timeout=5):
            check(time.monotonic() < deadline,
                  f"({label}) the processes did not finish in {timeout_s} s")
    finally:
        for proc in pc.processes:
            if proc.is_alive():
                proc.kill()
            proc.join(30)


def spawn_split_ranks(world: int, job: dict, tmp: str) -> list[dict]:
    """Run ``job`` on ``world`` ranks (:func:`split_rank`) with a deadline;
    each rank's record, with each run's logits and payloads."""
    first = job["runs"][0][0]
    spawned(split_rank, world,
            (world, os.path.join(tmp, f"pg-{first}"), tmp, job), first)
    ranks = []
    for r in range(world):
        with open(os.path.join(tmp, f"{first}_rank{r}.json")) as f:
            ranks.append(json.load(f))
        for label, *_ in job["runs"]:
            ranks[-1][label].update(torch.load(
                os.path.join(tmp, f"{label}_rank{r}.pt")))
    return ranks


def step_parts(edge: list, cloud: list, parts=STEP_PARTS) -> dict:
    """Median ms of each part of a step across ranks (``parts``), from
    the edge rank's and its cloud peer's spans (:func:`traced_steps`) on
    one host clock."""
    per = {"edge": edge, "cloud": cloud}
    return {name: statistics.median(
        (per[r1][i][s1][x1] - per[r0][i][s0][x0]) * 1e3
        for i in range(len(edge)))
        for name, (r0, s0, x0), (r1, s1, x1) in parts}


def link_bytes(cfg, codec, transport: str, batch: int) -> tuple[int, int]:
    """Bytes a step sends each way: the payload (and its rate) edge to
    cloud, the bf16 logits back."""
    from repro_torch.compression.split_runtime import payload_bytes
    return (payload_bytes(cfg, codec, transport, batch),
            2 * batch * cfg.vocab_size)


def attention_layers(cfg, n_layers: int | None = None) -> int:
    """Attention layers among the first ``n_layers`` of ``cfg`` (all)."""
    return sum(spec.kind == "attn"
               for spec in cfg.layer_specs()[:n_layers])


def ranked_launches(label: str, ranks: list, cfg, steps: int, edge: dict):
    """Gate: every rank launches decode attention once an attention layer
    of its stage a step, over ``steps`` steps of ``cfg``'s split; each edge
    rank also the codec kernels of ``edge`` (name -> launches), and no
    rank any other kernel."""
    from repro_torch.compression.split_runtime import stage_layout

    half, _ = stage_layout(cfg)
    per_stage = {"edge": attention_layers(cfg, half),
                 "cloud": attention_layers(cfg) - attention_layers(cfg, half)}
    for r in ranks:
        got = {k: v for k, v in r[label]["launches"].items() if v}
        want = dict(edge) if r["stage"] == "edge" else {}
        if per_stage[r["stage"]]:
            want["decode_attention"] = per_stage[r["stage"]] * steps
        check(got == want, f"({label}) rank {r['rank']} ({r['stage']}) "
              f"launched {got}, want {want}")


def ranks_phase(smi: str, dev, ranks_ref: dict, moe_split: dict) -> dict:
    """Phase 11: the split runtime across ranks on this card, over gloo.
    (ad) codeqwen1.5-7b, (pod, data, model) = (2, 1, 1): ``raw`` against
    (g) and ``packed`` against (h), in every bit; (ae) qwen3-moe-235b-a22b
    cut to 2 layers, (2, 1, 2), ``packed`` against (ab).  Returns each
    run's launch counts per rank."""
    import gc
    import tempfile

    from repro_torch.configs import get_config

    t0 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    ad_cfg = get_config("codeqwen1.5-7b")
    ae_cfg = ep_config()
    h, g = ranks_ref["h"], ranks_ref["g"]
    steps_ad = h["inputs"].shape[0]
    steps_ae = moe_split["inputs"].shape[0]
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        ad = spawn_split_ranks(2, {
            "arch": "codeqwen1.5-7b", "overrides": {}, "mesh": (2, 1, 1),
            "in_turn": False, "max_seq": SPLIT_MAX_SEQ,
            "runs": [("ad-raw", "raw", None, g["inputs"]),
                     ("ad-packed", "packed", h["codec"], h["inputs"])]}, tmp)
        ae = spawn_split_ranks(4, {
            "arch": EP_ARCH, "overrides": {"num_layers": EP_LAYERS},
            "mesh": (2, 1, 2), "in_turn": True,
            "max_seq": FAMILY_PROMPT + FAMILY_NEW + 8,
            "runs": [("ae-packed", "packed", moe_split["codec"],
                      moe_split["inputs"])]}, tmp)
    print(f"split across ranks: gloo processes on one card, the crossing "
          f"staged through host buffers (a price of that staging, not of a "
          f"link); {smi}")

    # (ad): every bit of phase 5's one-process runs
    check([r["stage"] for r in ad] == ["edge", "cloud"], "(ad) stages")
    for label, want, quantizes in (("ad-raw", g, False),
                                   ("ad-packed", h, True)):
        for r in ad:
            check(torch.equal(r[label]["logits"], want["logits"]),
                  f"({label}) rank {r['rank']}: logits differ from the "
                  "one-process run's")
            check(r[label]["rates"] == ad[0][label]["rates"],
                  f"({label}) rank {r['rank']}: rates differ from the edge's")
        if quantizes:
            sent = ad[0][label]["payloads"]
            check(len(sent) == steps_ad and all(
                torch.equal(a, b) for a, b in zip(sent, want["payloads"])),
                f"({label}) payload bytes differ from (h)'s")
            check(ad[0][label]["rates"] == want["rates"],
                  f"({label}) rates differ from (h)'s")
        ranked_launches(label, ad, ad_cfg, steps_ad,
                        {"clip_quant": steps_ad} if quantizes else {})
        parts = step_parts(ad[0][label]["steps"], ad[1][label]["steps"])
        fwd, back = link_bytes(ad_cfg, want["codec"], label[3:], REQUESTS)
        print(f"({label}) codeqwen1.5-7b 16 + 16 layers on (pod, data, "
              f"model) = (2, 1, 1), {REQUESTS} sequences, {steps_ad} steps: "
              f"logits identical in every bit to "
              f"({'g' if label == 'ad-raw' else 'h'})"
              + (", payload bytes and rates identical to (h)'s"
                 if quantizes else "")
              + "; ms per step (median): " + ", ".join(
                  f"{k} {v:.3f}" for k, v in parts.items())
              + " (one process, (h): " + ", ".join(
                  f"{k} {v:.3f}" for k, v in h["parts"].items())
              + f"); link bytes per "
              f"step {fwd} edge to cloud, {back} back ({back / fwd:.1f}x); "
              f"peak device memory edge {ad[0][label]['peak_bytes'] / 1e9:.2f}"
              f" GB, cloud {ad[1][label]['peak_bytes'] / 1e9:.2f} GB "
              f"(parameters {ad[0]['param_bytes'] / 1e9:.2f} / "
              f"{ad[1]['param_bytes'] / 1e9:.2f} GB)")

    # (ae): expert-parallel stages against (ab)'s one-process run
    label = "ae-packed"
    check([r["stage"] for r in ae] == ["edge", "edge", "cloud", "cloud"],
          "(ae) stages")
    for r in ae[1:]:
        check(torch.equal(r[label]["logits"], ae[0][label]["logits"]),
              f"(ae) rank {r['rank']}: logits differ from rank 0's")
    check(len(ae[0][label]["payloads"]) == steps_ae and all(
        torch.equal(a, b) for a, b in zip(ae[0][label]["payloads"],
                                           ae[1][label]["payloads"])),
        "(ae) the edge's two model ranks sent different payloads")
    ranked_launches(label, ae, ae_cfg, steps_ae, {"clip_quant": steps_ae})
    want = moe_split["logits"]
    got = ae[0][label]["logits"]
    diff = float((got - want).abs().max())
    tol = EP_LAYER_TOL * float(want.abs().max())
    check(diff <= tol, f"(ae) logits {diff} from (ab)'s, tolerance {tol}")
    agree = float((got.argmax(-1) == want.argmax(-1)).float().mean())
    parts = step_parts(ae[0][label]["steps"], ae[2][label]["steps"])
    fwd, back = link_bytes(ae_cfg, moe_split["codec"], "packed", EP_BATCH)
    print(f"(ae) {EP_ARCH} at published width, {EP_LAYERS} of 94 layers "
          f"(1 + 1) on (pod, data, model) = (2, 1, 2), "
          f"{ae_cfg.num_experts // 2} experts a rank, packed, {EP_BATCH} "
          f"sequences, {steps_ae} steps: the model ranks of each stage "
          f"identical in every bit (payloads, logits); largest logit "
          f"difference from (ab)'s one-process run {diff} (tolerance "
          f"{tol}), greedy tokens agree {agree:.3f}; ms per step (median): "
          + ", ".join(f"{k} {v:.3f}" for k, v in parts.items())
          + f"; link bytes per step {fwd} edge to cloud, {back} back; peak "
          "device memory per rank " + ", ".join(
              f"{r['peak_bytes'] / 1e9:.2f}" for r in
              (x[label] for x in ae)) + " GB (parameters " + ", ".join(
              f"{r['param_bytes'] / 1e9:.2f}" for r in ae) + " GB)")
    gc.collect()
    torch.cuda.empty_cache()
    af = tiles_ranks_run(smi, dev)
    print(f"split-across-ranks phase: {time.perf_counter() - t0:.1f} s wall")
    return {**{lbl: [r[lbl]["launches"] for r in ranks]
               for ranks, lbls in ((ad, ("ad-raw", "ad-packed")),
                                   (ae, ("ae-packed",))) for lbl in lbls},
            "af-packed": af}


AF_LAYERS = 4           # codeqwen1.5-7b's 32 layers cut to 2 + 2
AF_MESH = (2, 2, 1)     # (pod, data, model): two edge and two cloud ranks
AF_SBLOCK = 2           # rows per tile: a tile spans rows of both stages


def tiles_ranks_run(smi: str, dev) -> list[dict]:
    """(af): the packed split runtime across four ranks on this card,
    (pod, data, model) = (2, 2, 1), with a tiled codec whose tiles span
    rows (N=4, ranges per GROUP channels x AF_SBLOCK of the boundary's
    rows, calibrated by min/max on the first step's (REQUESTS, 1, 4096)
    boundary), on codeqwen1.5-7b at published width cut to 2 + 2 layers:
    the edge ranks gather their rows and quantize the whole batch's
    tiles.  Gates: every rank's logits, the edge ranks' packed payloads
    and every rank's rates identical in every bit to the one-process
    runtime's on the same weights, codec and tokens; each edge rank
    launches the kernels the one-process run launched, each cloud rank
    none.  Returns each rank's launch counts."""
    import gc
    import tempfile

    from repro_torch.compression import split_runtime as SR
    from repro_torch.configs import get_config
    from repro_torch.core import CodecConfig, calibrate
    from repro_torch.kernels import _build

    cfg = dataclasses.replace(get_config("codeqwen1.5-7b"),
                              num_layers=AF_LAYERS)
    kw = dict(edge_device=dev, cloud_device=dev)
    sp = SR.init_split_params(cfg, torch.Generator(device=dev).manual_seed(0),
                              **kw)
    prompt = torch.as_tensor(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (REQUESTS, SPLIT_PROMPT)), device=dev)
    edge_part = SR._stage_parts(cfg, None, "raw", None)[0]
    with torch.inference_mode():
        y, _ = edge_part(sp["edge"], prompt[:, 0], SR.init_split_cache(
            cfg, REQUESTS, SPLIT_MAX_SEQ, **kw)[0], 0)
    codec = calibrate(CodecConfig(
        n_levels=4, granularity="tile", channel_axis=-1,
        channel_group_size=GROUP, spatial_block_size=AF_SBLOCK,
        clip_mode="minmax", backend="cuda"),
        samples=y.to(torch.float32).cpu().numpy())
    check(codec.tiles_span_rows() and SR.gathers_rows(codec, "packed"),
          "(af) the codec's tiles must span rows")
    sent, rated, payloads = [], [], []
    step = SR.make_split_decode_step(
        cfg, link_counted(codec, sent, rated, payloads), transport="packed",
        **kw)
    _build.reset_launches()
    logits, toks, _, dt = split_decode(
        step, sp, SR.init_split_cache(cfg, REQUESTS, SPLIT_MAX_SEQ, **kw),
        prompt)
    one = {k: v for k, v in _build.LAUNCHES.items() if v}
    inputs = fed_tokens(prompt, toks).cpu()
    steps = inputs.shape[0]
    rates = [float(r) for _, r in rated]
    one_parts = one_process_parts(cfg, codec, sp, inputs.to(dev), dev)
    logits, payloads = logits.cpu(), [p.cpu() for p in payloads]
    del sp, step, y
    gc.collect()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        ranks = spawn_split_ranks(4, {
            "arch": "codeqwen1.5-7b", "overrides": {"num_layers": AF_LAYERS},
            "mesh": AF_MESH, "in_turn": False, "max_seq": SPLIT_MAX_SEQ,
            "runs": [("af-packed", "packed", codec, inputs)]}, tmp)
    label = "af-packed"
    check([r["stage"] for r in ranks] == ["edge", "edge", "cloud", "cloud"],
          "(af) stages")
    for r in ranks:
        check(torch.equal(r[label]["logits"], logits),
              f"(af) rank {r['rank']}: logits differ from the one-process "
              f"run's (largest difference "
              f"{float((r[label]['logits'] - logits).abs().max())})")
        check(r[label]["rates"] == rates,
              f"(af) rank {r['rank']}: rates {r[label]['rates'][:3]}... "
              f"differ from the one-process run's {rates[:3]}...")
    for r in ranks[:2]:
        got = r[label]["payloads"]
        check(len(got) == steps and all(
            torch.equal(a, b) for a, b in zip(got, payloads)),
            f"(af) edge rank {r['rank']}: payload bytes differ from the "
            "one-process run's")
    check(one.get("decode_attention") == attention_layers(cfg) * steps,
          f"(af) the one-process run launched {one}, want decode_attention "
          f"{attention_layers(cfg)} layers x {steps} steps")
    ranked_launches(label, ranks, cfg, steps,
                    {k: v for k, v in one.items() if k != "decode_attention"})
    parts = step_parts(ranks[0][label]["steps"], ranks[2][label]["steps"])
    fwd, back = link_bytes(cfg, codec, "packed", REQUESTS)
    check(fwd == payloads[0].numel() + 4, f"(af) payload_bytes {fwd} against "
          f"{payloads[0].numel()} packed bytes and the rate")
    print(f"(af) codeqwen1.5-7b at published width, {AF_LAYERS // 2} + "
          f"{AF_LAYERS // 2} layers, on (pod, data, model) = {AF_MESH}, a "
          f"packed tiled codec whose tiles span rows (N=4, {GROUP} channels "
          f"x {AF_SBLOCK} rows a tile, {codec.plan.n_tiles} tiles), "
          f"{REQUESTS} sequences, {steps} steps: every rank's logits and "
          f"rates and both edge ranks' payload bytes identical in every bit "
          f"to the one-process runtime's ({dt / steps * 1e3:.1f} ms a step "
          f"there); each edge rank launched the one-process run's codec "
          f"kernels, every rank decode attention once a layer of its stage "
          f"a step (one process: {one}); "
          f"ms per step (median): " + ", ".join(
              f"{k} {v:.3f}" for k, v in parts.items())
          + " (one process: " + ", ".join(
              f"{k} {v:.3f}" for k, v in one_parts.items())
          + f"); link bytes per step {fwd} edge to cloud (the whole batch's "
          f"payload to each cloud rank), {back} back; peak device memory "
          "per rank " + ", ".join(
              f"{r[label]['peak_bytes'] / 1e9:.2f}" for r in ranks)
          + f" GB; {smi}")
    return [r[label]["launches"] for r in ranks]


# -- phase 12: the examples on the card ------------------------------------------

EXAMPLES_TIMEOUT_S = 600
# runs a module of repro_torch.examples as ``python -m`` does, through its
# ``main(argv)`` (argv: its name, the JSON file its results go to, its
# flags), and writes what ``main`` returned and the process's launch
# counts when it ends, whatever its exit status
EXAMPLE_RUNNER = (
    "import importlib, json, sys\n"
    "name, out = sys.argv[1], sys.argv[2]\n"
    "sys.argv = [name] + sys.argv[3:]\n"
    "from repro_torch.kernels import _build\n"
    "result = None\n"
    "try:\n"
    "    result = importlib.import_module(\n"
    "        'repro_torch.examples.' + name).main(sys.argv[1:])\n"
    "finally:\n"
    "    with open(out, 'w') as f:\n"
    "        json.dump({'launches': dict(_build.LAUNCHES),\n"
    "                   'result': result}, f)\n")
# label -> (example, flags); run at the reference's settings, at once
EXAMPLE_RUNS = {
    "quickstart": ("quickstart", []),
    "quickstart-cpu": ("quickstart", ["--device", "cpu"]),
    "split_inference": ("split_inference", []),
    "train_with_compression": ("train_with_compression", []),
    "demo-smoke": ("edge_cloud_demo", ["--smoke"]),
    "demo-tls": ("edge_cloud_demo", ["--smoke", "--tls", "--secret",
                                     "s3kr1t"]),
}
# (ah): the demo at codeqwen1.5-7b's published width cut to 4 layers
AH_LAYERS = 4
AH_FLAGS = ["--sessions=3", "--batch=4", "--seq=32", "--levels=8",
            "--granularity=channel", "--device=cuda"]


def example_runs(tmp: str) -> dict:
    """EXAMPLE_RUNS as concurrent subprocesses; each one's exit code,
    standard output and error, wall seconds and the launches of its own
    process (a demo's cloud child is not counted)."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(SRC)] + ([os.environ["PYTHONPATH"]]
                      if os.environ.get("PYTHONPATH") else [])))
    procs = {}
    t0 = time.perf_counter()
    for label, (name, flags) in EXAMPLE_RUNS.items():
        logs = [open(os.path.join(tmp, f"{label}.{k}"), "w+")
                for k in ("out", "err")]
        procs[label] = (subprocess.Popen(
            [sys.executable, "-c", EXAMPLE_RUNNER, name,
             os.path.join(tmp, f"{label}.json")] + flags,
            stdout=logs[0], stderr=logs[1], env=env, cwd=tmp), logs)
    out = {}
    try:
        for label, (proc, logs) in procs.items():
            left = EXAMPLES_TIMEOUT_S - (time.perf_counter() - t0)
            rc = proc.wait(timeout=max(left, 1))
            text = []
            for log in logs:
                log.seek(0)
                text.append(log.read())
            path = os.path.join(tmp, f"{label}.json")
            res = {"launches": {}, "result": None}
            if os.path.exists(path):
                with open(path) as f:
                    res = json.load(f)
            out[label] = {"rc": rc, "out": text[0], "err": text[1],
                          "s": time.perf_counter() - t0, **res}
    finally:
        for proc, logs in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait(30)
            for log in logs:
                log.close()
    return out


def ah_process(i: int, port: int, out_dir: str) -> None:
    """(ah)'s process ``i``: 0 the cloud (``run_cloud``), 1 the edge
    (``run_edge``), each on cuda:0 with codeqwen1.5-7b at published width
    cut to AH_LAYERS layers, drawn from the demo's seed; writes its
    launches, and the edge its sessions."""
    from repro_torch.configs import get_config
    from repro_torch.examples import edge_cloud_demo as ECD
    from repro_torch.kernels import _build
    from repro_torch.models import init_params

    torch.cuda.set_device(0)
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    args = ECD.build_parser().parse_args(AH_FLAGS + [f"--port={port}"])
    cfg = dataclasses.replace(get_config("codeqwen1.5-7b"),
                              num_layers=AH_LAYERS)
    model = (cfg, init_params(cfg, torch.Generator(device=dev)
                              .manual_seed(args.seed), device=dev))
    _build.reset_launches()
    t0 = time.perf_counter()
    if i == 0:
        ECD.run_cloud(args, model)
        out = {}
    else:
        ECD.wait_for_cloud(args, lambda: True, timeout_s=300)
        out = ECD.run_edge(args, model)
    torch.cuda.synchronize()
    out.update(role=("cloud", "edge")[i], s=time.perf_counter() - t0,
               launches=dict(_build.LAUNCHES),
               peak_bytes=torch.cuda.max_memory_allocated())
    with open(os.path.join(out_dir, f"ah{i}.json"), "w") as f:
        json.dump(out, f)


def examples_phase(smi: str, dev) -> dict:
    """Phase 12: the four examples as ``python -m
    repro_torch.examples.<name>`` subprocesses at the reference's
    settings, run at once: each exits 0; quickstart prints what its
    ``--device cpu`` run prints; train_with_compression's resumed run
    has the uninterrupted run's losses, bit for bit; the demo (``--smoke``, and with
    ``--tls --secret``) prints its OK line.  Then (ah): the demo's
    ``run_cloud`` and ``run_edge`` as two processes on the card at
    codeqwen1.5-7b's published width, AH_LAYERS layers, 4 x 32 tokens, 3
    sessions, N=8 per channel group: its own checks (reconstruction
    bit-exact with the in-process round trip, tail logits within rtol =
    atol = 1e-4) hold, and the edge launches the encode megakernel and
    the device rANS step loop.  Returns each run's launches."""
    import socket
    import tempfile

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        runs = example_runs(tmp)
    for label, r in runs.items():
        check(r["rc"] == 0, f"(examples) {label} exited {r['rc']}:\n"
              + r["out"][-2000:] + r["err"][-3000:])
    check(runs["quickstart"]["out"] == runs["quickstart-cpu"]["out"],
          "(examples) quickstart on the card printed other numbers than on "
          "the CPU:\n" + runs["quickstart"]["out"])
    tw = runs["train_with_compression"]["result"]
    check(tw["resumed"] == tw["base"][tw["resumed_from"]:],
          "(examples) the resumed run's losses differ from the uninterrupted "
          f"run's: {tw['resumed']} vs {tw['base']}")
    rows = re.findall(r"^\s+(tensor|channel)\s+\d+\s", runs[
        "split_inference"]["out"], re.M)
    check(len(rows) == 8, f"(examples) split_inference printed {len(rows)} "
          "rows of its table")
    for label in ("demo-smoke", "demo-tls"):
        out = runs[label]["out"]
        check("[edge] OK: streamed cloud reconstruction is bit-exact" in out
              and out.count("bit-exact=True tail logits match=True") == 2,
              f"(examples) {label}:\n{out}")
    si = runs["split_inference"]["launches"]
    check(si.get("clip_quant", 0) > 0 and si.get("clip_quant_tiles", 0) > 0,
          f"(examples) split_inference launched {si}")
    for label, r in runs.items():
        print(f"(examples) {label}: exit 0, done {r['s']:.1f} s after the "
              "six runs started at once; launches " + json.dumps(
                  {k: v for k, v in r["launches"].items() if v}))
    for line in runs["quickstart"]["out"].splitlines()[-11:]:
        print(f"(examples) quickstart | {line}")
    print("(examples) quickstart's lines on the card equal its --device cpu "
          f"run's; train_with_compression resumed at step "
          f"{tw['resumed_from']}: its {len(tw['resumed'])} losses equal the "
          f"uninterrupted run's bit for bit (final loss {tw['resumed'][-1]!r})"
          f"; compressed final loss {tw['compressed'][-1]!r}")

    # (ah)
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    t1 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        spawned(ah_process, 2, (port, tmp), "ah", EXAMPLES_TIMEOUT_S)
        ah = []
        for i in range(2):
            with open(os.path.join(tmp, f"ah{i}.json")) as f:
                ah.append(json.load(f))
    cloud, edge = ah
    check(len(edge["sessions"]) == 3 and all(
        s_["bitexact"] and s_["logits_match"] for s_ in edge["sessions"]),
        f"(ah) sessions {edge['sessions']}")
    check(edge["launches"]["encode_tiles"] > 0
          and edge["launches"]["rans_step"] > 0,
          f"(ah) the edge's stream encode launched {edge['launches']}")
    print(f"(ah) edge_cloud_demo's run_cloud and run_edge as two processes "
          f"on one card, codeqwen1.5-7b at published width, {AH_LAYERS} "
          f"layers, batch 4 x seq 32, 3 sessions, N=8 per channel group of "
          f"8: bits/element per session " + ", ".join(
              f"{s_['bits_per_elem']:.4f}" for s_ in edge["sessions"])
          + " (vs 16.0 raw); reconstructions bit-exact, tail logits within "
          "rtol = atol = 1e-4 (largest difference " + ", ".join(
              f"{s_['logits_max_abs_diff']}" for s_ in edge["sessions"])
          + f"); the sessions' wall time {edge['wall_s']:.3f} s; launches: "
          f"edge " + json.dumps(
              {k: v for k, v in edge["launches"].items() if v})
          + ", cloud " + json.dumps(
              {k: v for k, v in cloud["launches"].items() if v})
          + f"; peak device memory edge {edge['peak_bytes'] / 1e9:.2f} GB, "
          f"cloud {cloud['peak_bytes'] / 1e9:.2f} GB; (ah) took "
          f"{time.perf_counter() - t1:.1f} s; {smi}")
    print(f"examples phase: {time.perf_counter() - t0:.1f} s wall")
    return {**{label: r["launches"] for label, r in runs.items()},
            "ah-edge": edge["launches"], "ah-cloud": cloud["launches"]}


def split_ranks_alone(smi: str, dev) -> None:
    """Phase 11 alone, with the one-process runs it is held to: phase 5's
    on the serve phase's model and (ab)'s on qwen3-moe-235b-a22b."""
    import gc

    from repro_torch.kernels import _build
    from repro_torch.launch import serve as S

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _build.library()        # built before phase 5's timed runs
    cfg, params = S.make_model("codeqwen1.5-7b", True, dev)
    _, ranks_ref = split_phase(cfg, params, dev)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    moe_split = family_split(*SPLIT_FAMILIES[0], dev)
    gc.collect()
    torch.cuda.empty_cache()
    ranks_phase(smi, dev, ranks_ref, moe_split)


def port_status(replaces: str) -> str:
    """A kernel's port status from the "Status" column of the row of
    ``PERF.md``'s kernel table that names its TPU kernel
    (``file.py:line``)."""
    key = "`" + replaces.rsplit("/", 1)[-1] + "`"
    col = None
    for ln in PERF.read_text().splitlines():
        cells = [c.strip() for c in ln.strip().strip("|").split("|")]
        if cells[0] == "#" and "Status" in cells:
            col = cells.index("Status")
        elif (col is not None and len(cells) > col and cells[0].isdigit()
              and key in cells[1]):
            return cells[col].replace(", ", "; ")
    raise AssertionError(f"PERF.md's kernel table has no row for {key}")


def rate_recorded(codec, rated: list):
    """``codec`` with each boundary it fake-quantizes, and the rate it
    returns, appended to ``rated``."""
    import dataclasses

    class Recorded(type(codec)):
        def apply_with_rate(self, x):
            deq, rate = super().apply_with_rate(x)
            rated.append((x.clone(), rate))
            return deq, rate

    return Recorded(**{f.name: getattr(codec, f.name)
                       for f in dataclasses.fields(codec)})


def same_rates(label: str, codec, rated: list, n: int) -> None:
    """Each recorded rate equals the two-launch path's on its boundary
    (quantize, then the index histogram, as the hookups ran before the
    quantizer counted its own indices)."""
    check(len(rated) == n, f"{label} recorded {len(rated)} boundaries")
    for x, rate in rated:
        two = codec.rate_from_indices(codec.quantize(x), tuple(x.shape))
        check(float(rate) == float(two), f"{label} rate {float(rate)!r} "
              f"!= the two-launch path's {float(two)!r}")
    print(f"{label}: {n} boundaries, each rate equal to the two-launch "
          "path's")


def device_ops(fn) -> list[str]:
    """Names of the device operations ``fn`` puts on the card (kernels,
    copies, fills), from ``torch.profiler``, after one warm call.  The
    session is padded by 20 ms of host time on each side of the call; on
    torch 2.11 a short session at times recorded no device event at all
    (PERF.md), so such a session is taken again, three in all."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            time.sleep(0.02)
            fn()
            torch.cuda.synchronize()
            time.sleep(0.02)
        names = [e.name for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA]
        if names:
            return names
    raise AssertionError("torch.profiler recorded no device operation in "
                         "3 sessions")


def crossing_ops(boundary, dev) -> dict:
    """Device operations of one decode crossing of the (a), (c) and (e)
    hookups (``apply_with_rate``) and of the (h), (l) and (n) split steps
    (their crossing, from the step's closure) -- a per-tensor, a
    per-channel g=8 and a per-tensor ECSQ N=4 codec at the boundary's
    range on the seeded decode boundary:
    the quantizer, histogram and pack stage, and the whole call.  Counted
    before the serving runs: on torch 2.11 a profiler session after their
    long profiles recorded none of this library's kernels (PERF.md)."""
    from repro_torch.compression import split_runtime as SR
    from repro_torch.configs import get_config
    from repro_torch.core import CodecConfig, calibrate

    def short(names):
        keys = ("clip_quant_tiles", "clip_quant_pack", "clip_quant",
                "ecsq_assign_tiles", "ecsq_assign_pack", "ecsq_assign",
                "index_histogram_tiles", "index_histogram", "pack_bits")
        return [next((k for k in keys if k in nm), nm[:40]) for nm in names]

    lo, hi = boundary["range"]
    x = boundary["decode"]
    tensor = calibrate(CodecConfig(n_levels=N_SERVE, clip_mode="manual",
                                   manual_cmin=lo, manual_cmax=hi,
                                   backend="cuda"))
    # per-channel g=8: ranges of the seeded boundary's channel groups
    channel = calibrate(CodecConfig(
        n_levels=N_SERVE, clip_mode="minmax", constrain_cmin_zero=False,
        granularity="channel", channel_axis=-1, channel_group_size=GROUP,
        backend="cuda"), boundary["prefill"].float().reshape(
            -1, x.shape[-1]).cpu().numpy())
    # per-tensor ECSQ N=4, designed on the seeded prefill boundary
    ecsq = calibrate(CodecConfig(
        n_levels=N_SERVE, clip_mode="manual", manual_cmin=lo,
        manual_cmax=hi, use_ecsq=True, ecsq_lagrangian=ECSQ_LAGRANGIAN,
        backend="cuda"), boundary["prefill"].float().reshape(-1)[::16]
        .cpu().numpy())
    out = {}
    with torch.inference_mode():
        for (hookup, split), codec in (("ah", tensor), ("cl", channel),
                                       ("en", ecsq)):
            spec = codec.spec()
            send, receive = SR._boundary(get_config("codeqwen1.5-7b"),
                                         codec, "packed")

            def cross(y, send=send, receive=receive, codec=codec):
                """The one-process packed step's crossing: the quantizer
                and rate of its edge stage, the ``.to`` of its crossing
                and the unpack and dequantize of its cloud stage."""
                wire, counts = send(y)
                rate = codec.rate_from_counts(counts, y.shape)
                return receive(wire.to(dev), y.shape), rate

            out[hookup] = {
                "stage": short(device_ops(
                    lambda c=codec, sp=spec:
                        c.backend.quantize_with_histogram(x, sp,
                                                          want_deq=True))),
                "whole_apply_with_rate": len(device_ops(
                    lambda c=codec: c.apply_with_rate(x)))}
            out[split] = {
                "stage": short(device_ops(
                    lambda c=codec, sp=spec:
                        c.backend.quantize_packed_with_histogram(
                            x, sp, c.bits_per_index()))),
                "whole_crossing": len(device_ops(lambda f=cross: f(x)))}
    want = {"a": "clip_quant", "h": "clip_quant_pack",
            "c": "clip_quant_tiles", "l": "clip_quant_tiles",
            "e": "ecsq_assign", "n": "ecsq_assign_pack"}
    for run_id, kernel in want.items():
        check(out[run_id]["stage"] == [kernel],
              f"({run_id}) quantizer + histogram (+ pack) stage: "
              f"{out[run_id]['stage']}")
    print("codec device operations per decode crossing: "
          + json.dumps(out))
    return out


def profiled(label: str, run) -> dict:
    """Repeat one serving run under ``torch.profiler``, print the device's
    busy time (summed kernel durations, one stream) against the wall
    clock, and return both with the idle share."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.time_range.elapsed_us() for e in kernels) / 1e3
    print(f"profile {label}: wall {wall_ms:.1f} ms, device busy "
          f"{busy_ms:.1f} ms, idle share {1 - busy_ms / wall_ms:.3f}, "
          f"{len(kernels)} device kernels")
    return {"wall_ms": wall_ms, "busy_ms": busy_ms,
            "idle_share": 1 - busy_ms / wall_ms, "kernels": len(kernels)}


def smi_line() -> str:
    """The card's name and power limit as ``nvidia-smi`` gives them."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip()
    return out.splitlines()[0]


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def _check_retired(reqs):
    check(all(r.done and len(r.out_tokens) == NEW_TOKENS for r in reqs),
          "a request did not retire with its tokens")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch" / "csrc").is_dir():
        print(f"chip_smoke: {SRC / 'repro_torch'} not found; run from a "
              "checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")

    # 1. device
    name = torch.cuda.get_device_name(0)
    probe = start_probe_build()
    smi = smi_line()
    sm_mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        timeout=60, check=True).stdout.split()[0])
    print(f"device: {name} (torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}); top SM clock {sm_mhz:.0f} MHz")
    print(smi)

    # 2. build
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    try:
        _build.library()
        cycles = chain_cycles(*probe, dev)
    finally:
        if probe[0].poll() is None:         # the kernels' build failed
            probe[0].kill()
            probe[0].wait()
    built = _build.build_seconds
    print(f"build: {time.perf_counter() - t0:.1f} s "
          f"({'compiled' if built is not None else 'cached'} "
          f"{_build.LIB_NAME}; the chain probe beside it)")
    print(f"rans step chain (one thread, {PROBE_ITERS} steps, clock64): "
          f"least chain {cycles['least']:.2f} cycles per step, the "
          f"kernel's form of the step {cycles['shipped']:.2f}; both reach "
          "the same state")

    # 3. kernels against their plain versions, then timings
    count_sizes()
    boundary = synthetic_boundary(dev)
    worst = max(kernel_checks(boundary, dev), tiled_checks(boundary, dev))
    pack_checks(dev)
    ecsq_tensor_checks(dev)
    # every torch.profiler count in one stretch, before the side streams
    # and the timings: a session after them recorded no device operation
    # on torch 2.11 (PERF.md)
    tile_ops = tile_histogram_checks(boundary, dev)
    crossing = crossing_ops(boundary, dev)
    two_stream_checks(dev)
    print(f"kernels: exact against their plain versions (worst "
          f"reconstruction {worst} ulp); index_histogram_tiles device "
          f"operations a call by route case: {json.dumps(tile_ops)}; "
          "histograms exact on two streams at once")
    rows = kernel_timings(boundary, dev, sm_mhz, cycles)

    # 4. serve
    cfg, params, counts, codecs, served = serve(dev)

    # 5. the packed split runtime on the same weights, then the codec
    # calls that still launch the standalone tile histogram and pack
    split_counts, ranks_ref = split_phase(cfg, params, dev)
    counts.update(split_counts)
    counts["m"] = codec_calls(boundary, codecs, dev)

    # 5b. the socket transport on the same weights and codecs
    counts.update(transport_phase(cfg, params, codecs, served))

    # 6. the accuracy harness: the serve phase's weights go in a list the
    # phase empties, so they are freed before its next model is built
    box = [params]
    del params
    eval_counts = eval_phase(cfg, box, dev)

    # 8. training gemma3-1b; (w)'s launches are read like a serving run's
    train = train_phase(dev)
    counts["w"] = train["w"]["launches"]

    # 9. the dry run's predictions against the card's steps
    dryrun_phase(smi, dev)

    # 10. the multi-device path: expert parallelism over two ranks on the
    # card, the split runtime on MoE and RWKV-6, the CLI under torchrun
    moe_split, dp_launches = distributed_phase(smi, dev)

    # 11. the split runtime across ranks: edge and cloud stages as gloo
    # processes on the card
    ranks_launches = ranks_phase(smi, dev, ranks_ref, moe_split)

    # 12. the examples as subprocesses on the card, then the demo's two
    # halves at published width
    example_launches = examples_phase(smi, dev)

    # 7. launch counts of the serving and split runs and of (m): each
    # kernel's count is read from the first run named here, and every
    # kernel must launch on each run listed for it
    runs_of = {"clip_quant": "ahijkw", "index_histogram": "m",
               "encode_tiles": "bdqrs", "rans_step": "bdfqrs",
               "clip_quant_tiles": "clm", "index_histogram_tiles": "m",
               "ecsq_assign": "enm", "ecsq_assign_tiles": "fm",
               "pack_bits": "m", "decode_attention": "abcdefghijkln",
               "prefill_attention": "abcdef"}
    check(sorted(r_["name"] for r_ in rows) == sorted(runs_of),
          "the kernel table must list every ported kernel")
    # each counts its indices in the quantizer (and (h)-(l), (n) pack
    # them)
    for run_id in "ahijkclenqrs":
        for kernel in ("index_histogram", "index_histogram_tiles",
                       "pack_bits"):
            check(counts[run_id][kernel] == 0, f"{kernel} launched "
                  f"{counts[run_id][kernel]} times on ({run_id})")
    # decode attention: once an attention layer a decode step, in the
    # serve runs (the decode steps after the prefill) and the split runs
    n_attn = attention_layers(cfg)
    for run_id in runs_of["decode_attention"]:
        steps = NEW_TOKENS - 1 if run_id in "abcdef" \
            else SPLIT_PROMPT + SPLIT_NEW
        check(counts[run_id]["decode_attention"] == n_attn * steps,
              f"decode_attention launched {counts[run_id]['decode_attention']}"
              f" times on ({run_id}), want {n_attn} layers x {steps} steps")
    # prefill attention: once an attention layer a prefill into a cache;
    # each serve run has one, the opening prefill of its 4 requests in 4
    # slots ((b), (d), (f) in its two halves), and no refill
    for run_id in runs_of["prefill_attention"]:
        check(counts[run_id]["prefill_attention"] == n_attn,
              f"prefill_attention launched "
              f"{counts[run_id]['prefill_attention']} times on ({run_id}), "
              f"want {n_attn} layers x 1 prefill")
    for r_ in rows:
        name_ = r_["name"]
        r_["status"] = port_status(r_["replaces"]) if r_["replaces"] \
            else "new; replaces no TPU kernel"
        r_["launches"] = counts[runs_of[name_][0]][name_]
        r_["eval_launches"] = eval_counts.get(name_, 0)
        r_["train_launches"] = counts["w"][name_]
        r_["split_ranks_launches"] = {
            label: [c.get(name_, 0) for c in per_rank]
            for label, per_rank in ranks_launches.items()}
        r_["dp_engine_launches"] = [c.get(name_, 0) for c in dp_launches]
        r_["example_launches"] = {label: c.get(name_, 0)
                                  for label, c in example_launches.items()}
        for run_id in runs_of[name_]:
            check(counts[run_id][name_] > 0, f"{name_} never "
                  f"launched on serving run ({run_id})")
        # launches per run at each size class; a row's sizes named after
        # a route ("plan prefill") take the class of their last word
        for size, t in r_["sizes"].items():
            cls = size if name_ in ("clip_quant", "clip_quant_tiles",
                                    "ecsq_assign", "ecsq_assign_tiles") \
                else size.split()[-1]
            route = runs_of[name_] if name_ != "encode_tiles" else \
                "s" if size.startswith("plan tick") else \
                "d" if size.startswith("plan") else \
                "r" if size.startswith("tick") else "b"
            if name_ == "rans_step" and size.startswith("tick"):
                # the tick's per-session launches are decode-size ones,
                # counted under "decode" already
                route = ""
            if name_ in ("clip_quant_tiles", "index_histogram_tiles"):
                # (m)'s 2-D plan has sizes of its own
                route = "m" if "2-D" in size or "element" in size \
                    else route.replace("m", "")
            if name_ == "decode_attention" and size != "decode" or \
                    name_ == "prefill_attention" and size != "prefill":
                # the runs launch them at their own shapes, timed as
                # "decode" and "prefill"
                route = ""
            t["launches"] = {run_id: RUN_SIZES[run_id].get((name_, cls), 0)
                             for run_id in route}
    # the time each kernel loses to its bound in one run of phases 4-5 and
    # (m): launches x (time - bound), summed over its timed sizes
    def lost(r_):
        return sum(sum(t["launches"].values()) * (t["ms"] - t["bound_ms"])
                   for t in r_["sizes"].values())

    print("ranking, launches x (time - bound) over the runs, ms: "
          + ", ".join(f"{r_['name']} {lost(r_):.4f}" for r_ in rows))
    for run_id, c in counts.items():
        print(f"launches ({run_id}): "
              + ", ".join(f"{k} {v}" for k, v in c.items() if v)
              + "; by size: " + ", ".join(
                  f"{k} {cls} {v}" for (k, cls), v in
                  sorted(RUN_SIZES[run_id].items())))
    print("launches (eval, phase 6's sweeps): "
          + ", ".join(f"{k} {v}" for k, v in eval_counts.items()))
    print("codec device operations per decode crossing: "
          + json.dumps(crossing))
    print(smi)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

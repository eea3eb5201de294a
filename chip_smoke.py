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
   whole wrapper
   call; for the rANS step loop: one chunk, the 16-chunk batch, a
   decode tensor), beside the plain version's time and the bound (for
   the step loop, the larger of its byte bound and its dependent chain:
   the cycles of the step's least dependent chain, measured in this run
   by ``tools/rans_chain_probe.cu``, per step at the top SM clock
   ``nvidia-smi`` reports);
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
   run; (a), (c) and (e) count their indices in the quantizer's launch
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
   finite, with decisive tokens;
7. launches -- each run's launch counts against the kernels it must
   launch.  The device operations (``torch.profiler``) of one decode
   crossing of the (a), (c) and (e) hookups (``apply_with_rate``) and
   of the (h), (l) and (n) split steps' crossings are counted at the
   end of phase 3: their quantizer, histogram and pack stage must be
   one operation on each.

The line before the last is the per-kernel JSON record (each kernel's
numbers per size under ``sizes``, with its launches per run at that
size, its launches in phase 6 under ``eval_launches``, and its port
status); the last line is
``{"ok": true, "device": {...}}``.  Without a CUDA device, or outside a
checkout of the repository, it exits non-zero and prints no result.
"""

from __future__ import annotations

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
ROADMAP = ROOT / "ROADMAP.md"    # its queue B table: each kernel's status
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


def bound(n_bytes: float, n_ops: float) -> tuple[float, str]:
    """Least time for the work: bytes over the memory rate vs operations
    over the CUDA-core rate (ms, and which one binds)."""
    t_mem = n_bytes / MEM_BYTES_PER_S * 1e3
    t_ops = n_ops / FP32_OPS_PER_S * 1e3
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
    return {"prefill": pre.to(torch.bfloat16),
            "decode": dec.to(torch.bfloat16), "range": (-2.2, 2.9)}


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
            b_ms, b_by = bound(c["nbytes"], c["nops"])
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

    for size, x in bnd.items():
        x2d, _ = ops._to_2d(x.float().reshape(-1), lo)
        r, c = x2d.shape
        sizes[size] = encode_case(
            x2d, torch.full((r, 1), float(lo), device=dev),
            torch.full((r, 1), float(hi), device=dev), (c, 1),
            fcq.band_valid_array(1, c, None, device=dev))
    for size, x in bnd.items():
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

    check(all(r_["sizes"][s]["max_abs_err"] == 0 for r_ in rows
              for s in r_["sizes"]
              if r_["name"] not in ("clip_quant", "clip_quant_tiles")),
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
    counts, tok_s, rates, seen = {}, {}, {}, {}

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
        rates[run_id] = float(np.mean(eng.rate_log))
    for run_id in ("a", "b"):
        profiled(f"({run_id})", lambda: S.run(cfg, params, **hookups[run_id],
                                              **run_kw))
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
    return cfg, params, counts, codecs


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
    check(float(rate_t) == float(ecsq_t._rate_from_counts(
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
    boundary with its rate to ``rated``, and each packed payload the
    quantizer made to ``payloads``."""
    import dataclasses

    class Counted(type(codec)):
        def quantize_with_rate(self, x, want_deq=False):
            idx, deq, rate = super().quantize_with_rate(x, want_deq)
            sent.append(idx.numel() * idx.element_size())
            rated.append((x.clone(), rate))
            return idx, deq, rate

        def quantize_packed_with_rate(self, x):
            packed, rate = super().quantize_packed_with_rate(x)
            sent.append(packed.numel() * packed.element_size())
            rated.append((x.clone(), rate))
            payloads.append(packed.clone())
            return packed, rate

        def pack(self, idx):
            out = super().pack(idx)
            sent[-1] = out.numel() * out.element_size()
            return out

    return Counted(**{f.name: getattr(codec, f.name)
                      for f in dataclasses.fields(codec)})


def split_decode(step, params, caches, prompt):
    """Feed ``prompt`` (B, P) one token per step, then greedy tokens until
    ``SPLIT_NEW`` have been fed.  Returns (logits per step, generated
    tokens (B, SPLIT_NEW), mean rate bits, seconds)."""
    logits_all, rates, fed = [], [], []
    tok = prompt[:, 0]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for pos in range(SPLIT_PROMPT + SPLIT_NEW):
        logits, caches, rate = step(params, tok, caches, pos)
        logits_all.append(logits)
        rates.append(rate)
        nxt = logits.argmax(-1)
        tok = prompt[:, pos + 1] if pos + 1 < SPLIT_PROMPT else nxt
        if pos + 1 >= SPLIT_PROMPT:
            fed.append(nxt)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    return (torch.stack(logits_all), torch.stack(fed[:SPLIT_NEW], 1),
            float(np.mean([float(r) for r in rates])), dt)


def split_phase(cfg, params, dev) -> dict:
    """Runs (g)-(l) and (n) of the packed split runtime; returns their
    launch counts."""
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

    counts, out = {}, {}
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
        check(len(payloads) == (steps if fused else 0),
              f"({run_id}) the quantizer packed {len(payloads)} payloads")
        if kind is not None:
            same_rates(f"({run_id})", codecs[kind], rated, steps)
        for (x, _), packed in zip(rated, payloads):
            two = codecs[kind].pack(codecs[kind].quantize(x).reshape(-1))
            check(torch.equal(packed, two), f"({run_id}) the quantizer's "
                  "packed payload differs from quantize, then pack")
        if run_id == "h":
            profiled("(h)", lambda: split_decode(
                step, sp, SR.init_split_cache(cfg, b, SPLIT_MAX_SEQ,
                                              edge_device=dev,
                                              cloud_device=dev), prompt))

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

    add(eval_full_width("transformer-tensor", cfg, params.pop(), dev))
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


def port_status(replaces: str) -> str:
    """A kernel's port status from the "Port" column of the row of
    ``ROADMAP.md``'s queue B table that names its TPU kernel
    (``file.py:line``), without the source file it names."""
    key = "`" + replaces.rsplit("/", 1)[-1] + "`"
    col = None
    for ln in ROADMAP.read_text().splitlines():
        cells = [c.strip() for c in ln.strip().strip("|").split("|")]
        if cells[0] == "#" and "Port" in cells:
            col = cells.index("Port")
        elif (col is not None and len(cells) > col and cells[0].isdigit()
              and key in cells[1]):
            status = re.sub(r"^`csrc/[^`]*`,\s*", "", cells[col])
            return "ported " + status.replace(", ", "; ")
    raise AssertionError(f"ROADMAP.md queue B has no row for {key}")


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
    import inspect
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
            step = SR.make_split_decode_step(
                get_config("codeqwen1.5-7b"), codec, transport="packed",
                edge_device=dev, cloud_device=dev)
            cross = inspect.getclosurevars(
                inspect.unwrap(step)).nonlocals["cross"]
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


def profiled(label: str, run) -> None:
    """Repeat one serving run under ``torch.profiler`` and print the
    device's busy time (summed kernel durations, one stream) against the
    wall clock."""
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
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip()
    smi = smi.splitlines()[0]
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
    cfg, params, counts, codecs = serve(dev)

    # 5. the packed split runtime on the same weights, then the codec
    # calls that still launch the standalone tile histogram and pack
    counts.update(split_phase(cfg, params, dev))
    counts["m"] = codec_calls(boundary, codecs, dev)

    # 6. the accuracy harness: the serve phase's weights go in a list the
    # phase empties, so they are freed before its next model is built
    box = [params]
    del params
    eval_counts = eval_phase(cfg, box, dev)

    # 7. launch counts of the serving and split runs and of (m): each
    # kernel's count is read from the first run named here, and every
    # kernel must launch on each run listed for it
    runs_of = {"clip_quant": "ahijk", "index_histogram": "m",
               "encode_tiles": "bd", "rans_step": "bdf",
               "clip_quant_tiles": "clm", "index_histogram_tiles": "m",
               "ecsq_assign": "enm", "ecsq_assign_tiles": "fm",
               "pack_bits": "m"}
    check(sorted(r_["name"] for r_ in rows) == sorted(runs_of),
          "the kernel table must list every ported kernel")
    # each counts its indices in the quantizer (and (h)-(l), (n) pack
    # them)
    for run_id in "ahijkclen":
        for kernel in ("index_histogram", "index_histogram_tiles",
                       "pack_bits"):
            check(counts[run_id][kernel] == 0, f"{kernel} launched "
                  f"{counts[run_id][kernel]} times on ({run_id})")
    for r_ in rows:
        name_ = r_["name"]
        r_["status"] = port_status(r_["replaces"])
        r_["launches"] = counts[runs_of[name_][0]][name_]
        r_["eval_launches"] = eval_counts.get(name_, 0)
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
                "d" if size.startswith("plan") else "b"
            if name_ in ("clip_quant_tiles", "index_histogram_tiles"):
                # (m)'s 2-D plan has sizes of its own
                route = "m" if "2-D" in size or "element" in size \
                    else route.replace("m", "")
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

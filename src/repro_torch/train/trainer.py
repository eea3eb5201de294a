"""Training loop with the fault-tolerance substrate wired in:

  * periodic checkpoints (atomic; async ones snapshot to host and write
    on a thread);
  * automatic resume from the latest checkpoint (the data stream replays
    deterministically from the restored step -- no data-state files),
    the port's own or one the JAX package wrote;
  * failure injection for tests (raise at step k, restart, bit-exact
    continuation);
  * optional gradient compression with error feedback (the paper's
    quantizer applied to data-parallel reductions);
  * straggler watchdog: steps whose wall time exceeds
    ``straggler_factor`` x the running median are recorded.

The step is eager.  Under a ``DistContext`` (``ctx``) each rank trains
on its dp rows of every batch with its experts of each MoE layer, as
``launch.steps.make_train_step`` does: gradients averaged over the mesh,
the global norm reduced over the tp group.  A checkpoint keeps the
one-device layout (whole expert stacks): every rank gathers, the mesh's
rank 0 writes; a restore gives each rank its slice, so a checkpoint
crosses between tp sizes and to and from the JAX package.  Gradient
compression runs in the JAX package's stacked layout, so each of its
leaves (a layer leaf over all periods of its group) gets one clip range,
as the reference's does; under a tp axis of more than one rank an expert
leaf's clip range is the whole stack's, its statistics reduced over the
tp group (``compress_grads(..., ctx=)``).
"""

from __future__ import annotations

import dataclasses
import os
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist

from ..compression import (GradCompressionConfig, compress_grads,
                           init_error_feedback)
from ..configs.base import ModelConfig
from ..data.pipeline import DataConfig, stream
from ..models import init_params, loss_and_grads, resolve_device
from ..models.context import (average_grads, dp_rows, gather_experts,
                              mesh_mean, sharded)
from ..models.convert import (rank_part, shard_experts, stack_layers,
                              train_state_from_numpy, unstack_layers)
from ..optim import AdamWConfig, adamw_update, init_opt_state, warmup_cosine
from . import checkpoint as ckpt


@dataclasses.dataclass
class TrainerConfig:
    steps: int = 100
    ckpt_every: int = 20
    ckpt_dir: str = dataclasses.field(default_factory=lambda: os.path.join(
        tempfile.gettempdir(), "repro_torch_ckpt"))
    ckpt_async: bool = False
    warmup_steps: int = 10
    log_every: int = 10
    straggler_factor: float = 3.0
    grad_compression: GradCompressionConfig | None = None
    seed: int = 0


class Trainer:
    def __init__(self, cfg: ModelConfig, tcfg: TrainerConfig,
                 data_cfg: DataConfig, opt_cfg: AdamWConfig | None = None,
                 ctx=None, codec_fn=None, fail_at_step: int | None = None,
                 device="cuda"):
        self.cfg, self.tcfg, self.data_cfg = cfg, tcfg, data_cfg
        self.opt_cfg = opt_cfg or AdamWConfig()
        self.ctx = ctx
        self.codec_fn = codec_fn
        self.fail_at_step = fail_at_step  # test hook
        self.device = resolve_device(device)
        self.metrics_log: list[dict] = []
        self.straggler_steps: list[int] = []
        self._writer = None             # the async checkpoint write

    def _step(self, params, opt_state, ef, batch, step):
        """One training step on ``batch`` (numpy or tensors) at ``step``:
        returns (params, opt_state, ef, metrics)."""
        def dev(a):
            # this rank's rows of the global batch
            return None if a is None else dp_rows(
                torch.as_tensor(a, device=self.device), self.ctx)

        (loss, _), grads = loss_and_grads(
            self.cfg, params, dev(batch["tokens"]),
            inputs=dev(batch.get("inputs")), codec_fn=self.codec_fn,
            remat=False, ctx=self.ctx)
        grads = average_grads(grads, self.ctx)
        gc = self.tcfg.grad_compression
        if gc is not None and gc.enabled:
            cg, ne, cmetrics = compress_grads(
                gc, stack_layers(self.cfg, grads), stack_layers(self.cfg, ef),
                ctx=self.ctx)
            grads, ef = unstack_layers(self.cfg, cg), \
                unstack_layers(self.cfg, ne)
        else:
            cmetrics = {}
        lr_scale = warmup_cosine(torch.tensor(step, device=self.device),
                                 warmup_steps=self.tcfg.warmup_steps,
                                 total_steps=self.tcfg.steps)
        params, opt_state, m = adamw_update(self.opt_cfg, params, grads,
                                            opt_state, lr_scale,
                                            ctx=self.ctx)
        return params, opt_state, ef, {"loss": mesh_mean(loss, self.ctx),
                                       **m, **cmetrics}

    # -- state ------------------------------------------------------------------

    def init_state(self):
        """The initial state from the seed (every rank draws the whole
        model, then keeps its experts)."""
        gen = torch.Generator(device=self.device).manual_seed(self.tcfg.seed)
        params = shard_experts(self.cfg, init_params(self.cfg, gen,
                                                     device=self.device),
                               self.ctx)
        return {"params": params, "opt": init_opt_state(params),
                "ef": init_error_feedback(params)}

    def _restore(self, step: int, state):
        """Checkpoint ``step`` as the port's state (this rank's experts
        under a context); one the JAX package wrote (its layers stacked)
        is converted."""
        keys = ckpt.manifest(self.tcfg.ckpt_dir, step)["keys"]
        if any(k.startswith("params/groups/") for k in keys):
            return train_state_from_numpy(
                self.cfg, ckpt.load_tree(self.tcfg.ckpt_dir, step),
                device=self.device, ctx=self.ctx)
        return ckpt.restore(
            self.tcfg.ckpt_dir, step, state,
            select=lambda key, a: rank_part(a, key.split("/"), self.ctx))

    def _save(self, step: int, state) -> None:
        self.wait_for_checkpoint()
        whole = gather_experts(state, self.ctx)
        # the mesh's rank 0 writes
        if not sharded(self.ctx) or dist.get_rank() == 0:
            self._writer = ckpt.save(self.tcfg.ckpt_dir, step, whole,
                                     async_=self.tcfg.ckpt_async)

    def wait_for_checkpoint(self) -> None:
        """Wait for an async checkpoint write still in flight."""
        if self._writer is not None:
            self._writer.join()
            self._writer = None

    def run(self, resume: bool = True) -> dict:
        state = self.init_state()
        start = 0
        if resume:
            last = ckpt.latest_step(self.tcfg.ckpt_dir)
            if last is not None:
                state = self._restore(last, state)
                start = last
        durations: list[float] = []
        try:
            for step, batch in zip(range(start, self.tcfg.steps),
                                   stream(self.data_cfg, start)):
                if self.fail_at_step is not None and \
                        step == self.fail_at_step:
                    raise RuntimeError(f"injected failure at step {step}")
                t0 = time.time()
                p, o, e, metrics = self._step(state["params"], state["opt"],
                                              state["ef"], batch, step)
                metrics = {k: float(v) for k, v in metrics.items()}
                state = {"params": p, "opt": o, "ef": e}
                dt = time.time() - t0
                if durations and \
                        dt > self.tcfg.straggler_factor * np.median(durations):
                    self.straggler_steps.append(step)
                durations.append(dt)
                metrics["step"] = step
                self.metrics_log.append(metrics)
                if (step + 1) % self.tcfg.ckpt_every == 0 or \
                        step + 1 == self.tcfg.steps:
                    self._save(step + 1, state)
        finally:
            self.wait_for_checkpoint()
        if sharded(self.ctx):
            # every rank returns once rank 0's last checkpoint is on disk
            dist.barrier()
        return state

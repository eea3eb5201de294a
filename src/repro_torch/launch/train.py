"""Training launcher: `python -m repro_torch.launch.train --arch <id> [...]`.

Trains on ``--device`` (default ``cuda``; there is no silent CPU
fallback) from random weights drawn from seed 0, on the repo's seeded
Zipf token stream.  The default runs a reduced config; ``--full`` uses
the real architecture.  ``--grad-compress-bits B`` quantizes every
gradient to 2**B levels with error feedback before the update.

``--distributed`` joins the process group that ``torchrun`` (``python -m
torch.distributed.run``) describes in the environment: NCCL on
``cuda:LOCAL_RANK`` for a CUDA device, gloo for the CPU.  As in the
reference, no ``DistContext`` reaches the trainer: each rank trains the
whole model on the whole batch.  With more than one rank, rank ``r > 0``
checkpoints under ``<ckpt-dir>/rank<r>`` and only rank 0 prints.
"""

from __future__ import annotations

import argparse
import os
import tempfile


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="Train a model of the registry with the port.")
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=64)
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(),
                                                       "repro_torch_train"))
    ap.add_argument("--full", action="store_true",
                    help="use the full-size config")
    ap.add_argument("--grad-compress-bits", type=int, default=0)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; 'cpu' runs the CPU "
                         "path)")
    ap.add_argument("--distributed", action="store_true",
                    help="join the torchrun process group (nccl on "
                         "cuda:LOCAL_RANK, gloo on the CPU)")
    args = ap.parse_args(argv)
    if not args.distributed:
        return _train(args, args.device, args.ckpt_dir, verbose=True)

    import torch
    import torch.distributed as dist

    device = torch.device(args.device)
    if device.type == "cuda":
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
        torch.cuda.set_device(device)
        dist.init_process_group("nccl", device_id=device)
    else:
        dist.init_process_group("gloo")
    try:
        rank, world = dist.get_rank(), dist.get_world_size()
        ckpt_dir = args.ckpt_dir if rank == 0 else \
            os.path.join(args.ckpt_dir, f"rank{rank}")
        if rank == 0:
            print(f"distributed: rank 0 of {world}, backend "
                  f"{dist.get_backend()}, device {device}")
        return _train(args, device, ckpt_dir, verbose=rank == 0)
    finally:
        dist.destroy_process_group()


def _train(args, device, ckpt_dir: str, verbose: bool):
    from ..compression import GradCompressionConfig
    from ..configs import get_config, reduced
    from ..data import DataConfig
    from ..train import Trainer, TrainerConfig

    cfg = get_config(args.arch)
    if not args.full:
        cfg = reduced(cfg)
    gc = None
    if args.grad_compress_bits:
        gc = GradCompressionConfig(n_levels=1 << args.grad_compress_bits)
    trainer = Trainer(
        cfg,
        TrainerConfig(steps=args.steps, ckpt_every=max(args.steps // 5, 1),
                      ckpt_dir=ckpt_dir, warmup_steps=args.steps // 10,
                      grad_compression=gc),
        DataConfig(vocab_size=cfg.vocab_size, batch=args.batch,
                   seq_len=args.seq_len,
                   embed_dim=cfg.d_model if cfg.input_mode == "embeddings"
                   else 0),
        device=device,
    )
    trainer.run(resume=args.resume)
    if not verbose:
        return trainer
    for m in trainer.metrics_log[:: max(len(trainer.metrics_log) // 10, 1)]:
        print(f"step {m['step']:5d}  loss {m['loss']:.4f}  "
              f"gnorm {m['grad_norm']:.3f}")
    print(f"final loss: {trainer.metrics_log[-1]['loss']:.4f}; "
          f"straggler steps: {trainer.straggler_steps}")
    return trainer


if __name__ == "__main__":
    main()

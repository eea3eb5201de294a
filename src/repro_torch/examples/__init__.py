"""The reference's four example scripts (``examples/`` at the repository
root) as modules of the port, each run as ``python -m
repro_torch.examples.<name>`` with the reference script's flags and
printed lines, plus ``--device`` (default ``cuda``; ``cpu`` runs the
model on the CPU and the codec on its torch backend):

  quickstart             -- the paper's codec on synthetic features
  split_inference        -- train, calibrate and serve a split model
  train_with_compression -- checkpoints, a failure and resume, and
                            gradient compression
  edge_cloud_demo        -- the edge and cloud halves as two processes
                            over a socket

Each does its work in functions that take the reference's numbers as
defaults; importing one runs nothing.
"""

import torch


def codec_backend(device) -> str:
    """The codec backend for a model on ``device``: the CUDA kernels on
    the card, the torch formulas on the CPU."""
    return "cuda" if torch.device(device).type == "cuda" else "torch"

"""Plain float32 forward pass of the decoder LMs the cells serve.

Pre-norm decoder layers, each a mixer and a feed-forward as its layer
kind's modules compute them (``bench/layers``); a token embedding and an
untied head, here.  The boundary quantizer runs between two layers at
every position.

It runs layer by layer over a list of :class:`Item` (sequence batches):
each layer's weights are made again from the seed (``bench.weights``),
widened to float32, used on every item and dropped, so at most one
float32 layer is on the device beside the activations.  Float32 matrix
products run without TF32.

``lowp=True`` is the control: every linear product takes its operands
through float8 (e4m3, one scale a tensor), the precision below the
configuration's bfloat16.
"""

from __future__ import annotations

import dataclasses

import torch

from .. import layers as L
from .. import weights as W
from . import codec as QC
from . import ops

# the ``model`` keys the embedding, the head and the layer loop read
# (``bench.layers.check_options``)
OPTIONS = ("vocab_size", "d_model", "dtype", "norm", "norm_eps", "num_layers",
           "pattern", "split_after_period")


@dataclasses.dataclass
class Item:
    """A batch of token rows run together.  ``first``: the first
    position whose logits are kept; ``edge_only``: stop at the boundary
    and keep its activations."""
    tokens: torch.Tensor                    # (B, L) integer
    first: int = 0
    edge_only: bool = False
    logits: torch.Tensor | None = None      # (B, L - first, V) float32
    boundary: torch.Tensor | None = None    # (B, L, d) float32


def layer_forward(x, p, spec: dict, model: dict, lowp: bool):
    """One layer: its mixer's residual block, then its feed-forward's."""
    for m in L.modules(spec):
        x = m.forward(x, p, spec, model, lowp)
    return x


def _widen(tree):
    if isinstance(tree, dict):
        return {k: _widen(v) for k, v in tree.items()}
    return tree.to(torch.float32)


class Reference:
    """The configuration file's model from ``seed``'s weights."""

    def __init__(self, config: dict, seed: int, device, lowp: bool = False):
        self.model = config["model"]
        self.seed, self.device, self.lowp = seed, torch.device(device), lowp
        self.specs = L.layer_specs(self.model)
        self.split = self.model["split_after_period"] \
            * len(self.model.get("pattern") or [{}])

    def run(self, items: list[Item], boundary) -> tuple:
        """Fill each item's ``logits`` (or ``boundary``); ``boundary(
        edge_items)`` is called once, after the edge layers, with the
        edge-only items' activations set, and returns ``(cmin, cmax,
        n_levels)``, the range every other item's boundary is quantized
        on.  Returns that range."""
        prev = (torch.backends.cuda.matmul.allow_tf32,
                torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        try:
            return self._run(items, boundary)
        finally:
            (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32) = prev

    @torch.no_grad()
    def _run(self, items, boundary):
        model, dev = self.model, self.device
        table = W.embed(model, self.seed, dev)
        xs = [table[it.tokens.to(dev).long()].to(torch.float32)
              for it in items]
        del table
        live = list(range(len(items)))
        qrange = None
        for i, spec in enumerate(self.specs):
            p = _widen(W.layer(model, i, self.seed, dev))
            for j in live:
                xs[j] = layer_forward(xs[j], p, spec, model, self.lowp)
            del p
            if i + 1 == self.split:
                edge = [j for j in live if items[j].edge_only]
                for j in edge:
                    items[j].boundary = xs[j]
                qrange = boundary([items[j] for j in edge])
                live = [j for j in live if not items[j].edge_only]
                for j in live:
                    xs[j] = QC.fake_quant(xs[j], *qrange)
        top = _widen(W.head(model, self.seed, dev))
        for j in live:
            x = ops.norm(xs[j][:, items[j].first:], top["final_norm"], model)
            b, n, d = x.shape
            items[j].logits = ops.lin(x.reshape(b * n, d), top["w"],
                                      self.lowp).view(b, n, -1)
            xs[j] = None
        return qrange

"""Weights from the seed, made on the device, layer by layer.

Each layer (and the embedding, and the head) draws from a generator of
its own, seeded from ``(seed, part)``, in one normal draw for all its
matrices in the model's dtype (and a float32 draw of its own for a
matrix that asks for one, as a router does), so the reference can make
any one layer again, bit for bit, without the others.  Scales and
means follow the port's initialisation (a uniform draw of the port's
is a normal one of the same mean and spread here); norms are ones (and
zero biases).  The tree is the port's parameter layout.  What a layer
holds, each layer kind's module says (``bench/layers``).
"""

from __future__ import annotations

import hashlib
import math

import torch

from . import layers as L

DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16,
          "float32": torch.float32}


def part_seed(seed: int, part: str) -> int:
    h = hashlib.sha256(f"{seed}:{part}".encode()).digest()
    return int.from_bytes(h[:8], "little") & ((1 << 63) - 1)


def _draw(shapes: list[tuple], scales: list[float], dtype, device,
          seed: int, part: str, means=None) -> list[torch.Tensor]:
    """Normal draws times each scale, plus each of ``means`` (zeros
    where None)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(part_seed(seed, part))
    sizes = [math.prod(s) for s in shapes]
    flat = torch.randn(sum(sizes), generator=gen, dtype=dtype, device=device)
    out, off = [], 0
    for shape, size, scale, mean in zip(shapes, sizes, scales,
                                        means or [0.0] * len(shapes)):
        t = flat[off:off + size].view(shape).mul_(scale)
        if mean:
            # added only where asked, so a zero-mean draw stays bit for bit
            t.add_(mean)
        out.append(t)
        off += size
    return out


def _norm(model: dict, dtype, device) -> dict:
    d = model["d_model"]
    p = {"scale": torch.ones(d, dtype=dtype, device=device)}
    if model.get("norm", "rmsnorm") == "layernorm":
        p["bias"] = torch.zeros(d, dtype=dtype, device=device)
    return p


def layer(model: dict, i: int, seed: int, device) -> dict:
    """Layer ``i``'s parameters: its norms, and under each module's
    ``GROUP`` the matrices it names (``bench/layers``), the mixer's then
    the feed-forward's, in one draw from the part ``layer<i>``."""
    spec = L.layer_specs(model)[i]
    dtype = DTYPES[model.get("dtype", "bfloat16")]
    named = [(m.GROUP, w) for m in L.modules(spec)
             for w in m.matrices(model, spec)]
    drawn = [(g, w) for g, w in named if w.own is None]
    tensors = _draw([w.shape for _, w in drawn], [w.scale for _, w in drawn],
                    dtype, device, seed, f"layer{i}",
                    means=[w.mean for _, w in drawn])
    p = {"norm1": _norm(model, dtype, device),
         "norm2": _norm(model, dtype, device)}
    for (group, w), t in zip(drawn, tensors):
        p.setdefault(group, {})[w.name] = t
    for group, w in named:
        if w.own is not None:
            t, = _draw([w.shape], [w.scale], torch.float32, device, seed,
                       f"{w.own}{i}", means=[w.mean])
            p.setdefault(group, {})[w.name] = t
    return p


def embed(model: dict, seed: int, device) -> torch.Tensor:
    dtype = DTYPES[model.get("dtype", "bfloat16")]
    table, = _draw([(model["vocab_size"], model["d_model"])], [0.02], dtype,
                   device, seed, "embed")
    return table


def head(model: dict, seed: int, device) -> dict:
    """The final norm and the (untied) head."""
    dtype = DTYPES[model.get("dtype", "bfloat16")]
    w, = _draw([(model["d_model"], model["vocab_size"])],
               [1 / math.sqrt(model["d_model"])], dtype, device, seed, "head")
    return {"final_norm": _norm(model, dtype, device), "w": w}


def params(model: dict, seed: int, device) -> dict:
    """The whole tree in the port's layout."""
    top = head(model, seed, device)
    return {"embed": {"table": embed(model, seed, device)},
            "final_norm": top["final_norm"], "head": {"w": top["w"]},
            "layers": [layer(model, i, seed, device)
                       for i in range(model["num_layers"])]}

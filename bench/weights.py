"""Weights from the seed, made on the device, layer by layer.

Each layer (and the embedding, and the head) draws from a generator of
its own, seeded from ``(seed, part)``, in one normal draw for all its
matrices in the model's dtype (and one float32 draw for a router), so
the reference can make any one layer again, bit for bit, without the
others.  Scales follow the port's initialisation; norms are ones (and
zero biases).  The tree is the port's parameter layout.
"""

from __future__ import annotations

import hashlib
import math

import torch

from .roofline import layer_specs

DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16,
          "float32": torch.float32}


def part_seed(seed: int, part: str) -> int:
    h = hashlib.sha256(f"{seed}:{part}".encode()).digest()
    return int.from_bytes(h[:8], "little") & ((1 << 63) - 1)


def _draw(shapes: list[tuple], scales: list[float], dtype, device,
          seed: int, part: str) -> list[torch.Tensor]:
    gen = torch.Generator(device=device)
    gen.manual_seed(part_seed(seed, part))
    sizes = [math.prod(s) for s in shapes]
    flat = torch.randn(sum(sizes), generator=gen, dtype=dtype, device=device)
    out, off = [], 0
    for shape, size, scale in zip(shapes, sizes, scales):
        out.append(flat[off:off + size].view(shape).mul_(scale))
        off += size
    return out


def _norm(model: dict, dtype, device) -> dict:
    d = model["d_model"]
    p = {"scale": torch.ones(d, dtype=dtype, device=device)}
    if model.get("norm", "rmsnorm") == "layernorm":
        p["bias"] = torch.zeros(d, dtype=dtype, device=device)
    return p


def layer(model: dict, i: int, seed: int, device) -> dict:
    """Layer ``i``'s parameters."""
    spec = layer_specs(model)[i]
    dtype = DTYPES[model.get("dtype", "bfloat16")]
    d, hd = model["d_model"], model["head_dim"]
    h, kh = model["num_heads"], model["num_kv_heads"]
    shapes = [(d, h, hd), (d, kh, hd), (d, kh, hd), (h, hd, d)]
    scales = [1 / math.sqrt(d)] * 3 + [1 / math.sqrt(h * hd)]
    if spec["moe"]:
        e, f = model["num_experts"], model["moe_d_ff"]
        shapes += [(e, d, f), (e, d, f), (e, f, d)]
        scales += [1 / math.sqrt(d), 1 / math.sqrt(d), 1 / math.sqrt(f)]
    else:
        f = model["d_ff"]
        shapes += [(d, f), (f, d), (d, f)]
        scales += [1 / math.sqrt(d), 1 / math.sqrt(f), 1 / math.sqrt(d)]
    wq, wk, wv, wo, a, b, c = _draw(shapes, scales, dtype, device, seed,
                                    f"layer{i}")
    p = {"norm1": _norm(model, dtype, device),
         "norm2": _norm(model, dtype, device),
         "attn": {"wq": wq, "wk": wk, "wv": wv, "wo": wo}}
    if spec["moe"]:
        router, = _draw([(d, model["num_experts"])], [1 / math.sqrt(d)],
                        torch.float32, device, seed, f"router{i}")
        p["moe"] = {"router": router, "w1": a, "w3": b, "w2": c}
    else:
        p["mlp"] = {"w1": a, "w2": b, "w3": c}
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
    if model.get("tie_embeddings"):
        raise NotImplementedError("tied embeddings")
    top = head(model, seed, device)
    return {"embed": {"table": embed(model, seed, device)},
            "final_norm": top["final_norm"], "head": {"w": top["w"]},
            "layers": [layer(model, i, seed, device)
                       for i in range(model["num_layers"])]}

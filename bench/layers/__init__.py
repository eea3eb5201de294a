"""Layer kinds, one module a kind, found by name.

A layer of a configuration's ``pattern`` is two residual blocks: a
mixer, ``bench/layers/<kind>.py`` for the spec's ``kind``, then a
feed-forward: ``moe.py`` where the spec sets ``moe``, otherwise the
module the mixer names in ``FEED_FORWARD`` where it names one (as an
RWKV mixer names ``cmix.py``, its channel mix), otherwise ``mlp.py``,
as the port picks them.
Each module gives, in plain torch (it imports neither JAX nor anything
of the program):

- its weights: ``GROUP``, the key of its parameters in a layer's tree
  (the port's layout), and ``matrices(model, spec)``, a :class:`Matrix`
  for each (its shape, and the spread and mean of its draw), in the
  order of the layer's one draw (``bench/weights.py``);
- ``forward(x, p, spec, model, lowp)``: its residual block in float32,
  ``x`` plus what it computes from the normed ``x``, with ``p`` the
  layer's tree; ``lowp``, the control, takes every linear product
  through float8;
- its frozen counts: ``params(model, spec)``, the parameters a token
  multiplies by, and ``context_flops(model, spec, contexts)``, the
  operations that depend on the context, over tokens whose context
  lengths (the token and the request's tokens before it) run through
  each ``(first, last)`` range of ``contexts``;
- ``OPTIONS``: the ``model`` and spec keys it reads.

A kind or a feed-forward the benchmark does not know yet is a new file
here, and nothing else changes.  :func:`check_options` refuses a
configuration that sets an option away from its neutral value where no
module of its layers reads it.
"""

from __future__ import annotations

import dataclasses
import importlib

# The port's options that change what a layer or the head computes, each
# at the value that leaves it out (the port's default), with the file
# that would implement another value.  ``window`` is a pattern entry's.
NEUTRAL = {
    "window": (None, "bench/layers/attn.py"),
    "attn_logit_softcap": (0.0, "bench/layers/attn.py"),
    "use_qk_norm": (False, "bench/layers/attn.py"),
    "pos_emb": ("rope", "bench/layers/attn.py"),
    "kv_quant_bits": (0, "bench/layers/attn.py"),
    "gated_mlp": (True, "bench/layers/mlp.py"),
    "final_logit_softcap": (0.0, "bench/reference/model.py"),
    "tie_embeddings": (False, "bench/weights.py and bench/reference/model.py"),
    "input_mode": ("tokens", "bench/reference/model.py"),
}


@dataclasses.dataclass(frozen=True)
class Matrix:
    """A weight matrix: normal draws times ``scale``, plus ``mean``
    (where the port draws a parameter about a value other than 0).
    ``own``: drawn alone, in float32, from the part seed
    ``<own><layer>``, and not in the layer's one draw in the model's
    dtype."""
    name: str
    shape: tuple
    scale: float
    own: str | None = None
    mean: float = 0.0


def layer_specs(model: dict) -> list[dict]:
    """The per-layer specs of a ``model`` section, the pattern repeated
    over ``num_layers`` (a remainder takes the pattern's head)."""
    pattern = model.get("pattern") or [{}]
    n = model["num_layers"]
    return [dict({"kind": "attn", "moe": False}, **pattern[i % len(pattern)])
            for i in range(n)]


def module(name: str):
    """``bench/layers/<name>.py``, or a module of that name elsewhere on
    this package's search path."""
    full = f"{__name__}.{name}"
    try:
        return importlib.import_module(full)
    except ModuleNotFoundError as e:
        if e.name != full:
            raise
        raise NotImplementedError(
            f"layer kind {name!r}: no module bench/layers/{name}.py "
            "gives its weights, forward and counts") from None


def modules(spec: dict) -> tuple:
    """A layer's mixer and feed-forward, in the order they run."""
    mixer = module(spec["kind"])
    ffn = "moe" if spec["moe"] else getattr(mixer, "FEED_FORWARD", "mlp")
    return mixer, module(ffn)


def check_options(model: dict, source: str, shared=()) -> None:
    """Refuse a ``model`` section (from ``source``) with a layer kind
    that has no module, or an option away from its neutral value that
    no module of its layers reads (nor ``shared``, the keys the
    embedding and head read)."""
    specs = layer_specs(model)
    read = set(shared)
    for spec in specs:
        mods = modules(spec)
        read.update(*(m.OPTIONS for m in mods))
        for key, value in spec.items():
            neutral, where = NEUTRAL.get(
                key, (None, f"bench/layers/{spec['kind']}.py"))
            if key not in ("kind", "moe") and value != neutral \
                    and not any(key in m.OPTIONS for m in mods):
                _refuse(source, key, value, where)
    for key, (neutral, where) in NEUTRAL.items():
        value = model.get(key, neutral)
        if value != neutral and key not in read:
            _refuse(source, key, value, where)


def _refuse(source: str, key: str, value, where: str):
    raise NotImplementedError(
        f"{source}: {key} = {value!r} is read by no module of its layers "
        f"and not by the embedding or head; the reference and the counts "
        f"would leave it out.  It would be implemented in {where}")

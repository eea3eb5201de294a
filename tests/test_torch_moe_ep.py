"""Port vs reference: the expert-parallel MoE (``moe_expert_parallel``)
forward and gradients, with dropped assignments.

The reference runs in one subprocess on four forced host devices, on
``("pod", "data", "model")`` meshes (1, 1, 2) and (1, 2, 2) whose axes
are all ``Auto`` (the reference's own multi-device test is red on this
jax: ``jax.make_mesh`` makes ``Explicit`` axes, which ``constrain``
rejects), at S=8 (the sequence path: all_to_all) and S=1 (the decode
path: psum); each case is one jitted ``jax.vjp`` of ``moe_apply`` under a
``DistContext`` with dp axes ("pod", "data").  The port runs the same
two meshes on 2 and 4 gloo CPU ranks: each rank takes its dp rows of
``x`` and its experts of each stack, and computes ``moe_apply`` and the
gradients of ``sum(out * r)``.

The config is reduced qwen3-moe-235b-a22b (8 experts, top-2, float32)
with its capacity factor lowered to 0.5, so assignments are dropped on
every case (asserted): per-shard capacity is where expert-parallel and
local dispatch differ.

Tolerances: outputs rtol = atol = 1e-5 (float32, sums in another
order); gradients rtol 1e-4, atol 1e-5.  A rank's input gradient is
compared with its rows of the reference's; the router's and the expert
stacks' gradients, summed over the dp ranks (each rank's covers its
rows), with the reference's.

A fault of the reference on this jax (ROADMAP.md C): on the decode path
its forward equals its own ``moe_local`` over each dp block's rows (the
capacity from the block's tokens, each expert's slots filled in token
order on either path), and its expert stacks' gradients agree with
``moe_local``'s, but its input and router gradients do not -- finite
differences of the forward agree with ``moe_local``'s.  So on that path
the port's input and router gradients are held to the reference's
``moe_local`` vjp over the same rows (computed in the same subprocess),
and its outputs and expert gradients to the expert-parallel run's.
"""

import dataclasses
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config, reduced
from repro_torch.launch.mesh import Mesh, device_mesh
from repro_torch.models import DistContext
from repro_torch.models import context as C
from repro_torch.models import moe as MOE
from test_torch_context import spawn

pytestmark = pytest.mark.timeout(600)

CF = 0.5                # capacity factor: assignments are dropped
B = 64
SEQS = (8, 1)           # the sequence path, the decode path
MESHES = ((1, 1, 2), (1, 2, 2))
NAMES = ("pod", "data", "model")
OUT_TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)
KEYS = ("router", "w1", "w3", "w2")

_SCRIPT = textwrap.dedent("""
    import os
    import sys
    from concurrent.futures import ThreadPoolExecutor
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import dataclasses
    import numpy as np
    import jax
    import jax.numpy as jnp
    from jax.sharding import AxisType
    from repro.configs import ARCHS, reduced
    from repro.models import moe as MOE
    from repro.models.context import DistContext

    inp = dict(np.load(sys.argv[1]))
    cfg = dataclasses.replace(reduced(ARCHS["qwen3-moe-235b-a22b"]),
                              capacity_factor=float(inp["cf"]))
    p = {k: jnp.asarray(inp[k]) for k in ("router", "w1", "w3", "w2")}
    jobs = []
    for shape in ((1, 1, 2), (1, 2, 2)):
        mesh = jax.make_mesh(shape, ("pod", "data", "model"),
                             axis_types=(AxisType.Auto,) * 3,
                             devices=jax.devices()[:int(np.prod(shape))])
        ctx = DistContext(mesh, ("pod", "data"))
        for s in (8, 1):
            def case(x, p, r, ctx=ctx):
                out, vjp = jax.vjp(lambda x, p: MOE.moe_apply(x, p, cfg, ctx),
                                   x, p)
                return (out,) + vjp(r)
            jobs.append((f"{shape[1]}x{shape[2]}/S{s}", s, jax.jit(case)))

    def run(job):
        tag, s, fn = job
        return fn(jnp.asarray(inp[f"x{s}"]), p, jnp.asarray(inp[f"r{s}"]))

    # the function the decode path computes: moe_local over each dp
    # block's rows (capacity from the block's tokens)
    for dp in (1, 2):
        def local(x, p, r, dp=dp):
            def f(x, p):
                blocks = x.reshape(dp, -1, x.shape[-1])
                return jnp.stack([MOE.moe_local(b, p, cfg) for b in blocks]
                                 ).reshape(x.shape)
            out, vjp = jax.vjp(f, x, p)
            return (out,) + vjp(r)
        jobs.append((f"{dp}x2/S1/local", 1, jax.jit(local)))

    with ThreadPoolExecutor(4) as pool:     # XLA compiles off the GIL
        results = list(pool.map(run, jobs))
    out = {}
    for (tag, _, _), (o, gx, gp) in zip(jobs, results):
        out[tag + "/out"], out[tag + "/g_x"] = np.asarray(o), np.asarray(gx)
        for k, v in gp.items():
            out[tag + "/g_" + k] = np.asarray(v)
    np.savez(sys.argv[2], **out)
    print("REFERENCE_EP_OK")
""")


def _cfg(**kw):
    return dataclasses.replace(reduced(get_config("qwen3-moe-235b-a22b")),
                               capacity_factor=CF, **kw)


def _inputs() -> dict:
    """Seeded float32 weights of one MoE layer, inputs and cotangents."""
    cfg = _cfg()
    rng = np.random.default_rng(0)
    d, e, f = cfg.d_model, cfg.num_experts, cfg.moe_d_ff
    out = {"cf": np.float32(CF),
           "router": rng.standard_normal((d, e)) / np.sqrt(d),
           "w1": rng.standard_normal((e, d, f)) / np.sqrt(d),
           "w3": rng.standard_normal((e, d, f)) / np.sqrt(d),
           "w2": rng.standard_normal((e, f, d)) / np.sqrt(f)}
    for s in SEQS:
        out[f"x{s}"] = rng.standard_normal((B, s, d))
        out[f"r{s}"] = rng.standard_normal((B, s, d))
    return {k: np.asarray(v, np.float32) for k, v in out.items()}


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    path = tmp_path_factory.mktemp("ep_in") / "inputs.npz"
    np.savez(path, **_inputs())
    return path


@pytest.fixture(scope="module")
def reference(inputs, tmp_path_factory):
    """The reference's four cases, once (one subprocess, see above)."""
    path = tmp_path_factory.mktemp("ep_ref") / "reference.npz"
    out = subprocess.run([sys.executable, "-c", _SCRIPT, str(inputs),
                          str(path)], capture_output=True, text=True,
                         timeout=600)
    assert "REFERENCE_EP_OK" in out.stdout, out.stdout + out.stderr
    return dict(np.load(path))


def _ep_ranks(rank, shape, inputs, out_dir):
    ctx = DistContext(device_mesh(Mesh(shape, NAMES), "cpu"),
                      ("pod", "data"))
    inp = dict(np.load(inputs))
    cfg = _cfg()
    sl = C.expert_slice(ctx, cfg.num_experts)
    p = {k: torch.from_numpy(inp[k] if k == "router" else inp[k][sl].copy())
         .requires_grad_() for k in KEYS}
    res = {"dp_rank": ctx.dp_rank, "tp_rank": ctx.tp_rank}
    for s in SEQS:
        x = C.dp_rows(torch.from_numpy(inp[f"x{s}"]), ctx).requires_grad_()
        r = C.dp_rows(torch.from_numpy(inp[f"r{s}"]), ctx)
        out = MOE.moe_apply(x, p, cfg, ctx)
        grads = torch.autograd.grad((out * r).sum(), [x] + [p[k]
                                                             for k in KEYS])
        res[f"S{s}/out"] = out.detach()
        for k, g in zip(("x",) + KEYS, grads):
            res[f"S{s}/g_{k}"] = g
    # an expert count the tp axis does not divide: the local route
    cfg7 = _cfg(num_experts=7)
    p7 = MOE.init_moe(torch.Generator().manual_seed(3), cfg7, torch.float32)
    x = torch.from_numpy(inp["x8"][:4])
    res["local_route_equal"] = torch.equal(
        MOE.moe_apply(x, p7, cfg7, ctx),
        MOE.moe_local(x.reshape(-1, cfg7.d_model), p7, cfg7).reshape(x.shape))
    try:
        MOE.moe_expert_parallel(x, p7, cfg7, ctx)
        res["ep_raised"] = False
    except ValueError as e:
        res["ep_raised"] = "not divisible" in str(e)
    np.savez(out_dir / f"rank{rank}.npz",
             **{k: np.asarray(v.detach() if isinstance(v, torch.Tensor)
                              else v) for k, v in res.items()})


@pytest.fixture(scope="module", params=MESHES,
                ids=lambda s: f"{s[1]}x{s[2]}")
def ranks(request, inputs, tmp_path_factory):
    """Each rank's results on one mesh (one spawn of 2 or 4 ranks)."""
    shape = request.param
    tmp = tmp_path_factory.mktemp("ep_ranks")
    world = int(np.prod(shape))
    spawn(_ep_ranks, world, tmp, shape, inputs, tmp)
    return shape, [dict(np.load(tmp / f"rank{r}.npz")) for r in range(world)]


@pytest.mark.parametrize("s", SEQS)
def test_assignments_are_dropped(s):
    """Every case drops assignments at its per-shard capacity, so the
    comparison below sees per-shard capacity at work."""
    cfg, inp = _cfg(), _inputs()
    router = torch.from_numpy(inp["router"])
    for _, dp, m in MESHES:
        x = torch.from_numpy(inp[f"x{s}"])
        rows = B // dp
        seq = s // m if s % m == 0 and s >= m else s
        t = rows * seq
        cap = MOE._capacity(t, cfg.experts_per_token, cfg.num_experts, CF)
        _, i = MOE._route(x[:rows, :seq].reshape(t, -1), router,
                          cfg.experts_per_token)
        _, keep, _, _ = MOE._dispatch_indices(i, cfg.experts_per_token,
                                              cfg.num_experts, cap)
        assert 0 < int(keep.sum()) < t * cfg.experts_per_token


@pytest.mark.parametrize("s", SEQS)
def test_expert_parallel_matches_reference(reference, ranks, s):
    shape, res = ranks
    _, dp, m = shape
    tag = f"{dp}x{m}/S{s}"
    rows = B // dp
    n_loc = _cfg().num_experts // m
    # the source of each gradient: on the decode path the input's and the
    # router's come from the reference's moe_local over the same rows,
    # the function its expert-parallel forward computes (see above)
    src = {k: f"{tag}/local" if s == 1 and k in ("x", "router") else tag
           for k in ("x",) + KEYS}
    if s == 1:
        np.testing.assert_allclose(reference[f"{tag}/out"],
                                   reference[f"{tag}/local/out"], **OUT_TOL)
    for rank, r in enumerate(res):
        a, j = divmod(rank, m)
        assert (int(r["dp_rank"]), int(r["tp_rank"])) == (a, j)
        mine = slice(a * rows, (a + 1) * rows)
        np.testing.assert_allclose(r[f"S{s}/out"],
                                   reference[f"{tag}/out"][mine], **OUT_TOL)
        np.testing.assert_allclose(r[f"S{s}/g_x"],
                                   reference[f"{src['x']}/g_x"][mine],
                                   **GRAD_TOL)
    for j in range(m):
        group = [res[a * m + j] for a in range(dp)]
        for k in KEYS:
            got = sum(r[f"S{s}/g_{k}"] for r in group)
            want = reference[f"{src[k]}/g_{k}"]
            if k != "router":
                want = want[j * n_loc:(j + 1) * n_loc]
            np.testing.assert_allclose(got, want, **GRAD_TOL, err_msg=k)


def test_expert_count_the_axis_does_not_divide_takes_the_local_route(ranks):
    for r in ranks[1]:
        assert bool(r["local_route_equal"]) and bool(r["ep_raised"])

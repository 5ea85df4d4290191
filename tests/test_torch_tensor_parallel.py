"""The tensor-parallel operators (``repro_torch/distributed/
tensor_parallel.py``) alone, on gloo ranks on the CPU, against a one-rank
run; the batch group of a multipod mesh (``DistContext.group`` over
("pod", "data")); the mesh builders' ``backend=``.

One spawn of ``tests/_torch_tp_worker.py --ops`` ranks a world of 2 and of
4 runs every operator on its blocks of the same numpy inputs, forward and
backward: ``to_model``/``from_model`` around a column-split product, a
tanh and a row-split product (an MLP); ``gather_model`` of a heads
dimension (forward only: its backward raises); ``split_rms_norm`` (its
``sum_model``) of a split width, then a row-split product (mamba2's
gated norm; also with ``from_model`` in ``sum_model``'s place, whose
identity backward gives the norm's input a wrong gradient);
``gather_model_grad`` of a column-split product's blocks, its two outputs
used as the EP moe router uses them (one for each rank's share of the
rows, one alike on every rank); ``vocab_embed`` of a
vocab-split table; ``vocab_xent`` of vocab-split logits whose padded
columns (13 of 16 used) lie in the last rank's block.  The parent runs
the same function with no group: the plain products, ``table[ids]`` and
``layers.softmax_xent``.  Forward outputs within 1e-6 (the sums over
ranks add in another order; the gather and the lookup exactly),
gradients within 1e-6, each rank's gradient of a split leaf its block of
the one-rank gradient, the padded columns' gradient exactly 0.  In the
test process, rank-free: the ssm and hybrid guards raise before any
work, where tp would cut a head or a gate block.  A world
of 8 on a (2, 2, 2) ("pod", "data", "model") mesh all-reduces each
rank's number over its batch group.  In the test process: the attention
leaves each rank uses for its own heads only pass through ``to_model``
(``transformer._partly_used``).
"""
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _torch_tp_worker as worker  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.distributed import DistContext  # noqa: E402
from repro_torch.launch import mesh as mesh_mod  # noqa: E402
from repro_torch.models import transformer  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
WORKER = Path(__file__).resolve().parent / "_torch_tp_worker.py"
WORLDS = (2, 4)
POD_MESH = (2, 2, 2)
TOL = 1e-6
SPAWN_TIMEOUT = 120
VOCAB, PADDED = 13, 16
# the dimension each output of ``ops_rank`` splits over the ranks (None:
# every rank holds all of it)
SPLIT = {"mlp": None, "mlp_gx": None, "mlp_gw_col": 1, "mlp_gw_row": 0,
         "gather": None, "norm": None, "norm_gy": 2, "norm_gw": 0,
         "norm_gw_out": 0, "embed": None, "embed_gtable": 0,
         "xent": None, "xent_glogits": 2, "router": None, "router_gx": None,
         "router_gw": 1}


def _inputs() -> dict:
    rng = np.random.default_rng(0)

    def f32(*shape):
        return rng.standard_normal(shape).astype(np.float32)
    B, S, d, F, H, hd = 2, 3, 8, 8, 4, 2
    return {"x": f32(B, S, d), "w_col": f32(d, F), "w_row": f32(F, d),
            "c": f32(B, S, d), "heads": f32(B, S, H, hd),
            "c_heads": f32(B, S, H, hd), "y": f32(B, S, F),
            "norm_w": f32(F) * 0.5, "table": f32(PADDED, d),
            "ids": rng.integers(0, VOCAB, (B, S)),
            "logits": f32(B, S, PADDED) * 3,
            "labels": rng.integers(0, VOCAB, (B, S)),
            "vocab_size": np.array(VOCAB)}


def _spawn(tmp: Path, world: int, mesh: str):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    env.pop("XLA_FLAGS", None)
    procs = []
    for r in range(world):
        with open(tmp / f"rank{r}.log", "w") as log:
            procs.append(subprocess.Popen(
                [sys.executable, str(WORKER), "--rank", str(r), "--world",
                 str(world), "--store", str(tmp / "store"), "--mesh", mesh,
                 "--cases", str(tmp.parent / "ops.npz"), "--out", str(tmp),
                 "--ops"], stdout=log, stderr=subprocess.STDOUT, env=env))
    return procs


@pytest.fixture(scope="module")
def spawned(tmp_path_factory):
    """{world: [each rank's outputs]} and {"group": [each rank's record]}:
    every spawn runs together."""
    tmp = tmp_path_factory.mktemp("tp-ops")
    np.savez(tmp / "ops.npz", **_inputs())
    runs = {w: (tmp / f"w{w}", f"1,{w}") for w in WORLDS}
    runs["group"] = (tmp / "group", ",".join(map(str, POD_MESH)))
    started = {}
    for name, (d, mesh) in runs.items():
        d.mkdir()
        started[name] = _spawn(d, int(np.prod([int(x) for x in
                                               mesh.split(",")])), mesh)
    deadline = time.monotonic() + SPAWN_TIMEOUT
    out = {}
    for name, procs in started.items():
        try:
            for p in procs:
                p.wait(timeout=max(deadline - time.monotonic(), 1))
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait(timeout=30)
        d = runs[name][0]
        logs = "\n".join((d / f"rank{r}.log").read_text()
                         for r in range(len(procs)))
        assert all(p.returncode == 0 for p in procs), logs[-6000:]
        out[name] = [json.loads((d / f"group-{r}.json").read_text())
                     if name == "group" else dict(np.load(d / f"ops-{r}.npz"))
                     for r in range(len(procs))]
    return out


@pytest.fixture(scope="module")
def one_rank():
    return worker.ops_rank(_inputs(), 0, 1, None)


@pytest.mark.parametrize("name", sorted(SPLIT))
@pytest.mark.parametrize("world", WORLDS)
def test_operator_matches_the_one_rank_run(spawned, one_rank, world, name):
    want = one_rank[name]
    exact = name in ("gather", "embed", "embed_gtable")
    for r, got in enumerate(spawned[world]):
        w = want
        if SPLIT[name] is not None:
            k = w.shape[SPLIT[name]] // world
            w = np.take(w, range(r * k, (r + 1) * k), axis=SPLIT[name])
        assert got[name].shape == w.shape, (world, r, name)
        if exact:
            np.testing.assert_array_equal(got[name], w, err_msg=f"{r} {name}")
        else:
            np.testing.assert_allclose(got[name], w, rtol=TOL, atol=TOL,
                                       err_msg=f"{world} {r} {name}")


@pytest.mark.parametrize("world", WORLDS)
def test_gather_model_refuses_a_gradient(spawned, world):
    """``gather_model``'s backward raises on every rank: its right
    gradient is this rank's block where the ranks use the gathered tensor
    alike, their sum where each does its own part (``sp_decode``)."""
    assert [bool(got["gather_refused"]) for got in spawned[world]] == \
        [True] * world


@pytest.mark.parametrize("world", WORLDS)
def test_identity_backward_gives_the_norm_input_a_wrong_gradient(
        spawned, one_rank, world):
    """With ``from_model`` (identity backward) in ``sum_model``'s place, the
    gated norm's forward is the same but each rank's gradient of the
    shared mean square misses the other ranks' parts: the gradient of the
    norm's input (in mamba2, what reaches ``w_x``, ``w_z``, ``w_dt`` and
    the residual stream) leaves the one-rank run's on every rank.  The
    norm weight's own gradient does not pass through the mean square's
    backward, and stays right."""
    for r, got in enumerate(spawned[world]):
        for name, dim in (("norm_gy", 2), ("norm_gw", 0)):
            want = one_rank[name]
            k = want.shape[dim] // world
            w = np.take(want, range(r * k, (r + 1) * k), axis=dim)
            np.testing.assert_allclose(got[name], w, rtol=TOL, atol=TOL)
            gap = np.abs(got[name.replace("norm_", "norm_identity_")] - w)
            if name == "norm_gy":
                assert gap.max() > 100 * TOL * np.abs(w).max(), (world, r)
            else:
                np.testing.assert_allclose(gap, 0, atol=TOL * np.abs(w).max())


@pytest.mark.parametrize("world", WORLDS)
def test_padded_vocab_columns_get_zero_gradient(spawned, world):
    """The cross entropy's gradient on the columns ``>= vocab_size`` is
    exactly 0 on the rank that holds them, and they are there."""
    k = PADDED // world
    held = 0
    for r, got in enumerate(spawned[world]):
        cols = np.arange(r * k, (r + 1) * k)
        pad = got["xent_glogits"][..., cols >= VOCAB]
        held += pad.shape[-1]
        assert np.all(pad == 0), (world, r)
        assert np.any(got["xent_glogits"][..., cols < VOCAB] != 0)
    assert held == PADDED - VOCAB


def test_batch_group_of_the_multipod_mesh(spawned):
    """On a (2, 2, 2) ("pod", "data", "model") mesh the tp batch group is
    ("pod", "data"): the four ranks of each ``model`` coordinate, in mesh
    order, made once; an all-reduce over it sums their ranks."""
    recs = spawned["group"]
    assert len(recs) == 8
    for r, rec in enumerate(recs):
        j = r % POD_MESH[2]
        ranks = [j + POD_MESH[2] * i for i in range(4)]
        assert rec["ranks"] == ranks, (r, rec)
        assert rec["rank_in_group"] == ranks.index(r)
        assert rec["sum"] == float(sum(ranks))
        assert rec["same"]


# ----------------------------------------------------------------------
# in the test process: no ranks
# ----------------------------------------------------------------------

def test_no_group_means_the_plain_functions():
    """Without a tp ``model`` group (no context, fsdp, a ``model`` axis of
    one rank) every operator is the identity or the plain function."""
    from repro_torch.distributed import tensor_parallel as tp
    cfg = get_config("yi-6b", reduced=True)
    for ctx in (None, DistContext.create(cfg, {"data": 2, "model": 1}),
                DistContext.create(cfg, {"data": 2, "model": 2},
                                   mode="fsdp")):
        assert tp.model_group(ctx) is None
        assert transformer.head_split(cfg, ctx) is None
    x = torch.randn(3, 4)
    assert tp.to_model(x, None) is x and tp.from_model(x, None) is x
    assert tp.sum_model(x, None) is x
    assert tp.gather_model(x, 1, None) is x


# (arch, config fields replaced, mesh): tp would cut a head of mamba2's
# d_inner (2 heads of 64 over 4 ranks, d_inner 128 split), and a gate
# block of recurrentgemma's width (8 blocks over 16 ranks, 64 split)
GUARDS = {"ssm_heads": ("mamba2-370m", {"ssm_headdim": 64},
                        {"data": 1, "model": 4}),
          "lru_blocks": ("recurrentgemma-9b", {},
                         {"data": 1, "model": 16})}


@pytest.mark.parametrize("step", ["train", "prefill", "decode"])
@pytest.mark.parametrize("guard", sorted(GUARDS))
def test_recurrent_tp_guards_raise_before_any_work(guard, step):
    """Where tp's rules split mamba2's ``d_inner`` but not its heads, or
    recurrentgemma's RG-LRU width over a ``model`` axis that does not
    divide its gate blocks, each step builder raises
    ``NotImplementedError`` naming the cut, rank-free (the context's axes
    only: no process group exists), and so does the layer itself."""
    import dataclasses

    from repro_torch.configs import TrainConfig
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.distributed import (
        build_decode_step, build_prefill_step, build_train_step,
    )
    from repro_torch.models import LM, griffin, ssm
    arch, replace, axes = GUARDS[guard]
    cfg = dataclasses.replace(get_config(arch, reduced=True), **replace)
    ctx = DistContext.create(cfg, axes, mode="tp")
    if guard == "ssm_heads":
        assert ctx.rules["ssm_inner"] == "model"
        assert ctx.rules["ssm_heads"] is None
    else:
        assert ctx.rules["lru"] == "model"
    lm = LM(cfg, max_seq=32, device="cpu")
    build = {"train": lambda: build_train_step(
        lm, TrainConfig(), ctx, ShapeConfig("t", "train", 32, 8)),
        "prefill": lambda: build_prefill_step(
            lm, ctx, ShapeConfig("p", "prefill", 32, 8)),
        "decode": lambda: build_decode_step(
            lm, ctx, ShapeConfig("d", "decode", 32, 8))}[step]
    match = "cuts through a head" if guard == "ssm_heads" else \
        "cuts through a block"
    with pytest.raises(NotImplementedError, match=match):
        build()
    x = torch.zeros(1, 2, cfg.d_model)
    with pytest.raises(NotImplementedError, match=match):
        if guard == "ssm_heads":
            ssm.ssm_forward({}, x, cfg, ctx)
        else:
            griffin.recurrent_forward({}, x, cfg, ctx=ctx)


@pytest.mark.parametrize("kv_split,want", [
    # heads split, kv heads whole: wk/wv and the qk norms are partly used
    (False, {"wk", "wv", "q_norm", "k_norm"}),
    # heads and kv heads split: the qk norms only
    (True, {"q_norm", "k_norm"}),
])
def test_partly_used_leaves_pass_through_to_model(kv_split, want):
    """The attention leaves whose gradients a tp step sums over ``model``
    enter through ``to_model``; the others, and every leaf when the heads
    are not split, are used as they are."""
    names = ("wq", "wk", "wv", "wo", "q_norm", "k_norm")
    pa = {n: torch.zeros(2, requires_grad=True) for n in names}
    hs = transformer.HeadSplit(object(), 0, 2, kv_split)
    got = transformer._partly_used(pa, hs)
    assert {n for n in names if got[n] is not pa[n]} == want
    assert all(type(got[n].grad_fn).__name__ == "_ToModelBackward"
               for n in want)
    assert transformer._partly_used(pa, None) is pa


def test_mesh_backend_default_and_mismatch(tmp_path, monkeypatch):
    """The default backend stays NCCL for CUDA and gloo for the CPU; a
    mesh whose device's default is not the process group's backend raises
    unless ``backend=`` names it (a CUDA mesh over gloo: two ranks on one
    card).  A world of one gloo rank in this process; the CUDA device
    and ``init_device_mesh`` are stood in for, since there is no card."""
    import torch.distributed as dist
    assert mesh_mod.BACKENDS == {"cuda": "nccl", "cpu": "gloo"}
    dist.init_process_group("gloo", store=dist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1)
    try:
        assert mesh_mod.make_dev_mesh(1, 1, device="cpu").mesh_dim_names == \
            ("data", "model")
        with pytest.raises(RuntimeError, match="runs on nccl"):
            mesh_mod.make_dev_mesh(1, 1, device="cpu", backend="nccl")
        made = []
        monkeypatch.setattr(mesh_mod, "resolve_device",
                            lambda d: torch.device(d))
        monkeypatch.setattr(mesh_mod, "init_device_mesh",
                            lambda *a, **k: made.append((a, k)) or "mesh")
        with pytest.raises(RuntimeError, match="a cuda mesh runs on nccl"):
            mesh_mod.make_dev_mesh(1, 1, device="cuda")
        assert mesh_mod.make_dev_mesh(1, 1, device="cuda",
                                      backend="gloo") == "mesh"
        assert made[0][0][:2] == ("cuda", (1, 1))
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("heads,kv,ways", [(4, 2, 4), (8, 2, 2), (6, 3, 2),
                                           (40, 10, 4)])
def test_kv_for_heads_follows_the_gqa_map(heads, kv, ways):
    """Each rank's block of q heads reads, through ``kv_for_heads``, the
    kv head GQA maps each of its q heads to (q head h: kv head
    h // (heads / kv)): a slice where the block falls on its kv heads in
    equal runs, one kv head a q head otherwise (6 heads over 3 kv heads
    at 2 ranks: 0, 0, 1 and 1, 2, 2)."""
    from repro_torch.models.attention import kv_for_heads
    k = torch.arange(kv, dtype=torch.float32).reshape(1, 1, kv, 1)
    n = heads // ways
    for r in range(ways):
        ks, vs = kv_for_heads(k, k.clone(), 2, r * n, n, heads // kv)
        g = n // ks.shape[2]
        got = ks.reshape(-1).repeat_interleave(g).tolist()
        assert got == [float((r * n + i) // (heads // kv)) for i in range(n)]
        assert torch.equal(ks, vs)

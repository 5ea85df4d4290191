"""One rank of the gloo runs of ``tests/test_torch_serve_steps.py``.

Imports torch and the port only (it checks that jax never loads).  The
parent test writes the weights and prompts of every family and the
sequence-parallel attention's inputs into an ``.npz`` and starts one
process a rank:

    python tests/_torch_serve_worker.py --rank R --world N --store FILE \\
        --mesh D,M --jobs steps:tp,sp --cases cases.npz --out DIR

``steps:MODE``: for each family (reduced configs, f32), the serve steps
(``build_prefill_step``, then ``STEPS`` x ``build_decode_step`` on its own
greedy ids) on a gloo mesh of D x M CPU ranks in ``MODE`` (``tp`` with
``sp_decode``, ``fsdp`` without).  Rank 0 writes each step's gathered
logits and ids and the gathered cache after prefill and after the last
step into ``DIR/steps.npz``; on a 1 x 1 mesh it also runs
``LM.prefill``/``LM.decode_step`` from the same weights and records
whether every logit and cache leaf has the same bits.

``sp``: ``sp_decode_attention`` in ``tp`` mode on this rank's rows and
cache slots, for every case of positions; each rank writes its output and
local caches into ``DIR/sp-R.npz``.
"""
from __future__ import annotations

import argparse
import sys
import warnings
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

FAMILIES = ("yi-6b", "mamba2-370m", "recurrentgemma-9b", "qwen2-moe-a2.7b",
            "internvl2-2b", "whisper-tiny")
# a 48-position prompt (not a multiple of the reduced mamba2's chunk of 32;
# above the reduced recurrentgemma's window of 32 and not a multiple of
# it: full causal attention), then STEPS greedy tokens
PROMPT, STEPS, BATCH = 48, 4, 4
CACHE = PROMPT + STEPS
# sp_decode_attention: the reference test's inputs
# (tests/test_sharding_subprocess.py:58-82)
SP_B, SP_KV, SP_S, SP_HD, SP_H = 4, 2, 64, 16, 4


def sp_positions() -> dict:
    """Cases of positions: the reference test's, every row at slot 0 (the
    ranks past the first hold no valid slot), and rows on the slice
    boundaries of a model axis of 2 and of 4."""
    return {"ref": [5, 17, 33, 63], "zero": [0, 0, 0, 0],
            "edges": [15, 16, 31, 32], "edges4": [47, 48, 0, 63]}


def _tree(flat: dict) -> dict:
    """{"['a']['b']": x} -> {"a": {"b": x}}."""
    out: dict = {}
    for path, x in flat.items():
        keys = [k.strip("'") for k in path[1:-1].split("][")]
        node = out
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = x
    return out


def _flat(tree, path: str = "") -> dict:
    if isinstance(tree, dict):
        return {p: x for k in sorted(tree)
                for p, x in _flat(tree[k], f"{path}[{k!r}]").items()}
    return {path: tree}


def _full(t) -> np.ndarray:
    from torch.distributed.tensor import DTensor
    if isinstance(t, DTensor):
        t = t.full_tensor()
    return t.detach().float().numpy().copy()


def run_steps(mesh, mode: str, data, out: dict) -> None:
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.distributed import (
        DistContext, build_decode_step, build_prefill_step, distribute_tree,
    )
    from repro_torch.models import LM

    fields = {n: n.split("|", 2) for n in data.files}
    for arch in FAMILIES:
        cfg = get_config(arch, reduced=True)
        lm = LM(cfg, max_seq=CACHE, device="cpu")
        ctx = DistContext.create(cfg, mesh, mode=mode,
                                 sp_decode=mode == "tp")
        pf, (p_sh, _, _, _) = build_prefill_step(
            lm, ctx, ShapeConfig("p", "prefill", PROMPT, BATCH),
            cache_len=CACHE)
        df, _ = build_decode_step(lm, ctx, ShapeConfig("d", "decode", CACHE,
                                                       BATCH))
        weights = {f[2]: data[n] for n, f in fields.items()
                   if f[:2] == [arch, "params"]}
        batch = {f[2]: data[n] for n, f in fields.items()
                 if f[:2] == [arch, "batch"]}
        full = lm.load_reference(_tree(weights))
        params = distribute_tree(full, ctx, p_sh)
        key = f"{mode}|{arch}"
        logits, cache = pf(params, batch)
        got = [_full(logits)]
        out[f"{key}|cache0"] = {p: _full(t) for p, t in _flat(
            {k: v for k, v in cache.items() if k != "filled"}).items()}
        ids = []
        tok = torch.from_numpy(got[-1]).argmax(dim=-1)[:, None]
        for _ in range(STEPS):
            ids.append(tok[:, 0].numpy().copy())
            logits, cache = df(params, cache, {"token": tok})
            got.append(_full(logits))
            tok = torch.from_numpy(got[-1]).argmax(dim=-1)[:, None]
        out[f"{key}|logits"] = np.stack(got)
        out[f"{key}|ids"] = np.stack(ids, axis=1)
        out[f"{key}|filled"] = np.array(cache["filled"])
        out[f"{key}|cache1"] = {p: _full(t) for p, t in _flat(
            {k: v for k, v in cache.items() if k != "filled"}).items()}
        if mesh.size() == 1:
            # the same prompt and tokens through LM's own calls
            extra = dict(batch)
            want, wcache = lm.prefill(extra.pop("tokens"), CACHE, **extra)
            same = np.array_equal(want.numpy(), got[0])
            same &= all(np.array_equal(_full(t), out[f"{key}|cache0"][p])
                        for p, t in _flat({k: v for k, v in wcache.items()
                                           if k != "filled"}).items())
            for s in range(STEPS):
                tok = torch.from_numpy(ids[s])[:, None]
                want, wcache = lm.decode_step(wcache, tok)
                same &= np.array_equal(want.numpy(), got[s + 1])
            same &= all(np.array_equal(_full(t), out[f"{key}|cache1"][p])
                        for p, t in _flat({k: v for k, v in wcache.items()
                                           if k != "filled"}).items())
            out[f"{key}|same_bits_as_lm"] = np.array(bool(same))


def run_sp(mesh, data, rank: int, outdir: Path) -> None:
    from repro_torch.configs import get_config
    from repro_torch.distributed import DistContext, sp_decode_attention

    ctx = DistContext.create(get_config("yi-6b", reduced=True), mesh,
                             mode="tp")
    n_data, n_model = mesh.shape
    i, j = mesh.get_coordinate()
    rows = slice(i * SP_B // n_data, (i + 1) * SP_B // n_data)
    slots = slice(j * SP_S // n_model, (j + 1) * SP_S // n_model)

    def t(name):
        return torch.from_numpy(data[f"sp|{name}"].copy())
    res = {}
    for case, pos in sp_positions().items():
        k = t("k")[rows, :, slots].clone()
        v = t("v")[rows, :, slots].clone()
        o, k2, v2 = sp_decode_attention(
            ctx, t("q")[rows], k, v, t("nk")[rows], t("nv")[rows],
            torch.tensor(pos, dtype=torch.int32)[rows])
        if k2 is not k or v2 is not v:
            raise AssertionError("the caches are not written in place")
        res[f"{case}|out"] = o.numpy()
        res[f"{case}|k"] = k.numpy()
        res[f"{case}|v"] = v.numpy()
    np.savez(outdir / f"sp-{rank}.npz", coord=np.array([i, j]), **res)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    for name in ("--rank", "--world"):
        ap.add_argument(name, type=int, required=True)
    for name in ("--store", "--mesh", "--jobs", "--cases", "--out"):
        ap.add_argument(name, required=True)
    args = ap.parse_args(argv)
    torch.set_num_threads(1)
    warnings.filterwarnings("ignore")

    from repro_torch.launch.mesh import make_dev_mesh

    dist.init_process_group("gloo", store=dist.FileStore(args.store,
                                                          args.world),
                            rank=args.rank, world_size=args.world)
    n_data, n_model = (int(x) for x in args.mesh.split(","))
    mesh = make_dev_mesh(n_data, n_model, device="cpu")
    data = np.load(args.cases)
    outdir = Path(args.out)
    out: dict = {}
    for job in args.jobs.split(","):
        if job == "sp":
            run_sp(mesh, data, args.rank, outdir)
        else:
            run_steps(mesh, job.split(":")[1], data, out)
    if args.rank == 0 and out:
        flat = {}
        for k, v in out.items():
            if isinstance(v, dict):
                flat.update({f"{k}|{p}": x for p, x in v.items()})
            else:
                flat[k] = v
        np.savez(outdir / "steps.npz", **flat)
    dist.destroy_process_group()
    if "jax" in sys.modules:
        raise AssertionError("the worker loaded jax")
    return 0


if __name__ == "__main__":
    sys.exit(main())

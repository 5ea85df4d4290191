"""The reference's sharded runs, in a process of its own with 8 host
devices, for the port's gloo tests (``tests/test_torch_moe_shardmap.py``,
``tests/test_torch_distributed.py``, ``tests/test_torch_tp.py``: the tp
train and serve steps at (1, 2), (2, 2) and (1, 4); ``tests/
test_torch_fsdp.py`` runs its single-device reference here, on a 1 x 1
mesh, beside its spawns).

The test process keeps its one CPU device (``tests/conftest.py``), so the
parent starts this script with ``XLA_FLAGS=--xla_force_host_platform_
device_count=8``:

    python tests/_jax_sharded_ref.py --jobs jobs.json --inputs in.npz \\
        --out out.npz

Every mesh is ``jax.make_mesh(shape, ("data", "model"), axis_types=
(AxisType.Auto,) * 2)``: on the default (Explicit) axis types the
reference's ``with_sharding_constraint`` raises under jax 0.9.0 (ROADMAP
queue C), on Auto axes its sharded steps and layers run.  ``jobs.json``
is a list of jobs, each a dict with ``kind``:

- ``layer``: ``moe_ffn`` of a config (``arch`` reduced, ``num_experts``,
  ``capacity_factor``) under ``moe_impl`` on the mesh, with
  ``jax.value_and_grad`` of ``sum(out * c) / T + aux`` in the weights and
  x; also the dense ``moe_ffn`` (no context) of the same inputs.  Inputs
  ``{key}|p|<keystr>``, ``{key}|x``, ``{key}|c``; outputs ``{key}|out``,
  ``|aux``, ``|dense``, ``|loss``, ``|grad|<keystr>``, ``|gx``.
- ``train``: two ``build_train_step`` steps (``mode``, tp by default;
  ``moe_impl``, ``microbatches``, no remat) from ``{key}|params|<keystr>``
  on the batch ``{key}|batch<s>|<name>`` (``tokens``, and an encdec's
  ``encoder_frames``): losses, grad norms, lrs, m after step 1 and master
  and parameters after step 2.
- ``serve``: ``build_prefill_step`` (cache ``cache`` slots) on
  ``{key}|batch|<name>`` then ``steps`` greedy ``build_decode_step``
  steps (``mode``, tp by default; ``sp_decode``): the logits of each, the
  ids, the cache after prefill and after the last step.

Configs are the reduced ones of ``repro.configs`` with the job's
``replace`` fields; weights and data come from the parent, made by numpy
or the port, so both packages read the same bits.  A job reads its inputs
under its ``inputs`` prefix (its ``key`` by default), so several jobs can
share one set.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys

os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=8")

import numpy as np  # noqa: E402


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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    for name in ("--jobs", "--inputs", "--out"):
        ap.add_argument(name, required=True)
    args = ap.parse_args(argv)

    import jax
    import jax.numpy as jnp
    from jax.sharding import AxisType

    from repro.configs import TrainConfig, get_config
    from repro.configs.base import ShapeConfig
    from repro.distributed.context import DistContext
    from repro.distributed.steps import (
        build_decode_step, build_prefill_step, build_train_step,
    )
    from repro.models import LM
    from repro.models.moe import moe_ffn
    from repro.optim import init_opt_state

    if jax.device_count() < 8:
        raise RuntimeError(f"{jax.device_count()} devices: start this with "
                           f"XLA_FLAGS=--xla_force_host_platform_device_count=8")
    with open(args.jobs) as f:
        jobs = json.load(f)
    data = np.load(args.inputs)
    out: dict = {}

    def flat(tree) -> dict:
        return {jax.tree_util.keystr(p): np.array(x, np.float32) for p, x in
                jax.tree_util.tree_flatten_with_path(tree)[0]}

    def inputs(prefix: str) -> dict:
        n = len(prefix)
        return _tree({k[n:]: jnp.asarray(data[k]) for k in data.files
                      if k.startswith(prefix)})

    def fields(prefix: str) -> dict:
        return {k[len(prefix):]: jnp.asarray(data[k]) for k in data.files
                if k.startswith(prefix)}

    for job in jobs:
        key = job["key"]
        src = job.get("inputs", key)      # the prefix of the job's inputs
        cfg = dataclasses.replace(get_config(job["arch"], reduced=True),
                                  **job.get("replace", {}))
        mesh = jax.make_mesh(tuple(job["mesh"]), ("data", "model"),
                             axis_types=(AxisType.Auto,) * 2)
        ctx = DistContext.create(cfg, mesh, sp_decode=job.get("sp_decode",
                                                               True),
                                 mode=job.get("mode", "tp"))
        if job.get("moe_impl"):
            ctx.extra["moe_impl"] = job["moe_impl"]
        if job["kind"] == "layer":
            p = inputs(f"{src}|p|")
            x, c = (jnp.asarray(data[f"{src}|{n}"]) for n in ("x", "c"))

            def loss(p, x):
                y, aux = moe_ffn(p, x, cfg, ctx)
                return jnp.sum(y * c) / (x.shape[0] * x.shape[1]) + aux, \
                    (y, aux)
            with mesh:
                (value, (y, aux)), (gp, gx) = jax.jit(jax.value_and_grad(
                    loss, argnums=(0, 1), has_aux=True))(p, x)
            out[f"{key}|out"] = np.array(y)
            out[f"{key}|aux"] = np.array(aux)
            out[f"{key}|loss"] = np.array(value)
            out[f"{key}|gx"] = np.array(gx)
            for k, g in flat(gp).items():
                out[f"{key}|grad|{k}"] = g
            out[f"{key}|dense"] = np.array(jax.jit(
                lambda p, x: moe_ffn(p, x, cfg, None)[0])(p, x))
        elif job["kind"] == "train":
            seq, batch = job["seq"], job["batch"]
            lm = LM(cfg, max_seq=seq)
            tc = TrainConfig(microbatches=job["microbatches"], remat="none",
                             **job["train"])
            params = inputs(f"{src}|params|")
            with mesh:
                step, _ = build_train_step(lm, tc, ctx, ShapeConfig(
                    "t", "train", seq, batch))
                opt = jax.tree_util.tree_map(
                    lambda a: jnp.array(a, copy=True), init_opt_state(params))
                for s in range(2):
                    params, opt, m = step(params, opt, fields(
                        f"{src}|batch{s}|"))
                    for k in ("loss", "grad_norm", "lr"):
                        out[f"{key}|{k}{s}"] = np.array(float(m[k]))
                    if s == 0:
                        for k, v in flat(opt.m).items():
                            out[f"{key}|m1|{k}"] = v
            for name, tree in (("master2", opt.master), ("params2", params)):
                for k, v in flat(tree).items():
                    out[f"{key}|{name}|{k}"] = v
        elif job["kind"] == "serve":
            prompt = fields(f"{src}|batch|")
            B, S = prompt["tokens"].shape
            lm = LM(cfg, max_seq=job["cache"])
            params = inputs(f"{src}|params|")
            with mesh:
                pf, _ = build_prefill_step(lm, ctx, ShapeConfig(
                    "p", "prefill", S, B), cache_len=job["cache"])
                df, _ = build_decode_step(lm, ctx, ShapeConfig(
                    "d", "decode", job["cache"], B))
                logits, cache = pf(params, prompt)
                for k, v in flat(cache).items():
                    out[f"{key}|cache0|{k}"] = v
                got, ids = [np.array(logits, np.float32)], []
                for _ in range(job["steps"]):
                    tok = jnp.argmax(logits, axis=-1)[:, None].astype(
                        jnp.int32)
                    ids.append(np.array(tok[:, 0]))
                    logits, cache = df(params, cache, {"token": tok})
                    got.append(np.array(logits, np.float32))
            out[f"{key}|logits"] = np.stack(got)
            out[f"{key}|ids"] = np.stack(ids, axis=1)
            for k, v in flat(cache).items():
                out[f"{key}|cache1|{k}"] = v
        else:
            raise ValueError(f"job kind {job['kind']!r}")
        print(f"done {key}", flush=True)
    np.savez(args.out, **out)
    return 0


if __name__ == "__main__":
    sys.exit(main())

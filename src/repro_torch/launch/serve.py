"""Batched serving driver on the port: prefill a prompt batch, decode N
greedy tokens; or serve many notebook sessions (the counterpart of
``repro/launch/serve.py``, every option of it accepted).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch yi-6b --reduced \\
        --batch 4 --prompt-len 48 --gen 16 [--device cuda|cpu]

``--device cuda`` (the default) runs prefill attention, the SSD scan and
the RG-LRU scan through the hand-written CUDA kernels and raises without a
card; ``--device cpu`` runs their plain PyTorch versions.  Every family
serves (e.g. ``--arch recurrentgemma-9b``, ``--arch qwen2-moe-a2.7b``,
``--arch internvl2-2b``, ``--arch whisper-tiny``); a vlm's prompt is its
patch embeddings and the rest text, an encdec's the decoder's tokens over
the pipeline's encoder frames.

Notebook-fleet mode serves many concurrent notebook *sessions* instead of
token batches: N users' sessions multiplexed by the SessionScheduler over a
shared accelerator fabric.

    PYTHONPATH=src python -m repro_torch.launch.serve --notebook-fleet 8 \\
        [--fleet-gpu-capacity 2] [--fleet-tpu-capacity 1] [--device cuda|cpu]

Gateway mode runs the persistent multi-tenant GatewayService instead of a
batch schedule: sessions attach/detach at will, a warm pool absorbs cold
starts, and deficit-round-robin admission divides capacity by tenant
weight.  ``--stress N`` drives a Poisson attach storm of N sessions
end-to-end over the wire protocol (real ATTACH/DETACH frames through a
WireFrontend):

    PYTHONPATH=src python -m repro_torch.launch.serve --gateway 32 \\
        --tenants alice:2,bob:1 --quota 16 --warm-pool 8 \\
        --max-sessions 64
    PYTHONPATH=src python -m repro_torch.launch.serve --gateway 0 --stress 2000

``--replicas K`` (gateway or notebook-fleet mode) keeps K follower
namespaces converged per session (failures promote instead of replaying)
and ``--race on`` adds first-result-wins cell racing on top.  In both
modes every session's state digests, chunk keys and quantization run on
``--device``.
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.data import TokenPipeline
from repro_torch.device import resolve_device
from repro_torch.models import LM


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def serve_lm(cfg, *, batch: int = 4, prompt_len: int = 48, gen: int = 16,
             seed: int = 0, device="cuda", dtype=torch.bfloat16,
             params=None) -> dict:
    """Prefill ``batch`` prompts of ``prompt_len`` positions from the seeded
    pipeline's whole ``prefill_batch(0)`` (the reference's prompts for the
    same seed: tokens, plus a vlm's ``vision_embeds``, which take
    ``num_patches`` of the positions, or an encdec's ``encoder_frames``),
    then decode ``gen`` greedy tokens; the argmax runs over
    ``padded_vocab``, pad columns included, as the reference's does.

    Weights: random from a ``torch.Generator`` seeded with ``seed`` in
    ``dtype``, or ``params``, a tree in the reference's layout of numpy
    arrays or CPU tensors (see :meth:`LM.load_reference`).

    Returns ``ids`` (batch, gen), the prefill logits and the last decode
    step's logits (f32 numpy), the wall times of prefill and decode (each
    ends in a device synchronise) and, on a card, the peak device memory
    of prefill and decode (the weights, the cache and the activations; the
    weight init's scratch is not counted)."""
    dev = resolve_device(device)
    total = prompt_len + gen
    lm = LM(cfg, max_seq=total, device=dev)
    shape = ShapeConfig("cli", "prefill", prompt_len, batch)
    batch_in = TokenPipeline(cfg, shape, seed=seed).prefill_batch(0)
    prompt = batch_in.pop("tokens")
    tokens = torch.from_numpy(prompt).to(dev)
    if params is None:
        lm.init(seed, dtype)
    else:
        lm.load_reference(params)
    _sync(dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)

    t0 = time.perf_counter()
    logits, cache = lm.prefill(tokens, cache_len=total, **batch_in)
    _sync(dev)
    t_prefill = time.perf_counter() - t0
    prefill_logits = logits

    toks = []
    t0 = time.perf_counter()
    tok = logits.argmax(dim=-1)[:, None]
    for _ in range(gen):
        toks.append(tok)
        logits, cache = lm.decode_step(cache, tok)
        tok = logits.argmax(dim=-1)[:, None]
    _sync(dev)
    t_decode = time.perf_counter() - t0

    return {"ids": torch.cat(toks, dim=1).cpu().numpy(),
            "prompt": prompt,
            "prefill_logits": prefill_logits.float().cpu().numpy(),
            "last_logits": logits.float().cpu().numpy(),
            "prefill_seconds": t_prefill, "decode_seconds": t_decode,
            "decode_tokens_per_s": gen * batch / t_decode if gen else 0.0,
            "peak_memory_bytes": (torch.cuda.max_memory_allocated(dev)
                                  if dev.type == "cuda" else None),
            "device": str(dev)}


def parse_tenant_spec(spec: str) -> list[tuple[str, float, int | None]]:
    """``name[:weight[:quota]],...`` -> [(name, weight, quota|None)];
    raises ValueError with a user-facing message on bad input."""
    out = []
    for item in spec.split(","):
        parts = item.split(":")
        name = parts[0].strip()
        if not name:
            raise ValueError(f"--tenants {spec!r}: empty tenant name "
                             f"(expected name[:weight[:quota]],...)")
        try:
            weight = float(parts[1]) if len(parts) > 1 else 1.0
        except ValueError:
            raise ValueError(
                f"--tenants {spec!r}: weight {parts[1]!r} for {name!r} is "
                f"not a number (expected name[:weight[:quota]])") from None
        if weight <= 0:
            raise ValueError(
                f"--tenants {spec!r}: weight for {name!r} must be positive "
                f"(got {weight})")
        quota: int | None = None
        if len(parts) > 2 and parts[2] not in ("", "none"):
            try:
                quota = int(parts[2])
            except ValueError:
                raise ValueError(
                    f"--tenants {spec!r}: quota {parts[2]!r} for {name!r} "
                    f"is not an integer (use 'none' for unlimited)") \
                    from None
            if quota < 1:
                raise ValueError(
                    f"--tenants {spec!r}: quota for {name!r} must be >= 1 "
                    f"(got {quota}; use 'none' for unlimited)")
        out.append((name, weight, quota))
    return out


def positive_int(flag: str, value: int, *, allow_zero: bool = False) -> int:
    floor = 0 if allow_zero else 1
    if value < floor:
        raise ValueError(f"{flag} must be >= {floor} (got {value})")
    return value


def serve_gateway(n_sessions: int, *, tenants=None, quota: int | None = None,
                  warm_pool: int = 8, max_sessions: int | None = None,
                  stress: int = 0, rate: float = 50.0,
                  think_mean: float = 20.0, cold_start: float = 5.0,
                  gpu_capacity: int = 16, seed: int = 0,
                  replicas: int = 0, race: bool = False,
                  device="cuda") -> dict:
    """Run the persistent gateway over the 3-env fabric.  Plain mode
    attaches ``n_sessions`` programmatically; ``stress`` > 0 additionally
    drives that many sessions as real ATTACH frames over a wire frontend
    (the end-to-end decode → admit → ack → DETACH-complete path).  Every
    session's reducer runs on ``device``."""
    from repro_torch.core import (
        EnvironmentRegistry, ExecutionEnvironment, GatewayService,
        LoopbackTransport, Notebook, poisson_attach_storm,
    )
    reg = EnvironmentRegistry(default_bandwidth=2e8, default_latency=0.5)
    reg.register(ExecutionEnvironment("local"), home=True,
                 capacity=max(64, n_sessions + stress))
    reg.register(ExecutionEnvironment("gpu-cloud", speedup=8.0),
                 capacity=gpu_capacity)
    reg.register(ExecutionEnvironment("tpu-mesh", speedup=40.0), capacity=4)
    reg.connect("local", "gpu-cloud", bandwidth=5e8, latency=0.3)
    reg.connect("local", "tpu-mesh", bandwidth=1e8, latency=1.0)
    gw = GatewayService(reg, warm_pool=warm_pool, cold_start=cold_start,
                        max_sessions=max_sessions, replicas=replicas,
                        race=race, device=device, policy="cost",
                        use_knowledge=False)
    names = []
    for name, weight, tquota in (tenants or [("default", 1.0, None)]):
        gw.add_tenant(name, weight=weight,
                      quota=tquota if tquota is not None else quota)
        names.append(name)

    def make_nb(i: int) -> Notebook:
        nb = Notebook(f"user-{i % 8}")
        nb.add_cell("import numpy as np\n"
                    "data = np.arange(200_000, dtype=np.float64)", cost=0.5)
        nb.add_cell("model = float(((data - data.mean()) ** 2).sum())",
                    cost=60.0)
        nb.add_cell("report = model / len(data)", cost=0.2)
        return nb

    if n_sessions:
        poisson_attach_storm(gw, n_sessions=n_sessions, rate=rate,
                             think_mean=think_mean, make_notebook=make_nb,
                             tenants=tuple(names), seed=seed)
    if stress:
        client, server = LoopbackTransport.pair()
        gw.add_frontend(server)
        poisson_attach_storm(gw, n_sessions=stress, rate=rate,
                             think_mean=think_mean, make_notebook=make_nb,
                             tenants=tuple(names), seed=seed + 1,
                             client=client)
    rep = gw.run()
    return {
        "sessions": rep.sessions, "completed": rep.completed,
        "errors": rep.errors, "peak_concurrent": rep.peak_concurrent,
        "makespan": rep.makespan,
        "attach_wait_p50": rep.attach_wait_p50,
        "attach_wait_p99": rep.attach_wait_p99,
        "queue_wait_p99": rep.queue_wait_p99,
        "decision_ms_p99": rep.decision_ms_p99,
        "pool": {"hits": rep.pool_hits, "misses": rep.pool_misses,
                 "refills": rep.pool_refills},
        "tenants": rep.tenants,
        "env_utilization": rep.env_utilization,
        "wire_sessions": stress,
        "replicas": replicas,
        "promotions": rep.promotions,
        "races": rep.races,
        "race_waste_seconds": rep.race_waste_seconds,
        "replica_lag_max": max(
            (r.replica_lag for r in rep.session_reports), default=0),
        "device": str(gw.device),
    }


def serve_notebook_fleet(n_sessions: int, *, gpu_capacity: int = 2,
                         tpu_capacity: int = 1, replicas: int = 0,
                         race: bool = False, device="cuda") -> dict:
    """N synthetic data-science sessions over a shared 3-env fabric; every
    session's reducer runs on ``device``."""
    from repro_torch.core import (
        EnvironmentRegistry, ExecutionEnvironment, Notebook, SessionScheduler,
    )
    reg = EnvironmentRegistry(default_bandwidth=2e8, default_latency=0.5)
    reg.register(ExecutionEnvironment("local"), home=True,
                 capacity=max(8, n_sessions))
    reg.register(ExecutionEnvironment("gpu-cloud", speedup=8.0),
                 capacity=gpu_capacity)
    reg.register(ExecutionEnvironment("tpu-mesh", speedup=40.0),
                 capacity=tpu_capacity)
    reg.connect("local", "gpu-cloud", bandwidth=5e8, latency=0.3)
    reg.connect("local", "tpu-mesh", bandwidth=1e8, latency=1.0)
    sched = SessionScheduler(reg, device=device)
    if replicas:
        sched.enable_replicas(replicas, race=race)
    for i in range(n_sessions):
        nb = Notebook(f"user-{i}")
        nb.add_cell("import numpy as np\n"
                    "data = np.arange(200_000, dtype=np.float64)", cost=0.5)
        nb.add_cell("model = float(((data - data.mean()) ** 2).sum())",
                    cost=60.0)
        nb.add_cell("report = model / len(data)", cost=0.2)
        sched.add_notebook(nb, policy="cost", use_knowledge=False)
    rep = sched.run()
    return {
        "sessions": n_sessions,
        "makespan": rep.makespan,
        "queue_events": rep.queue_events,
        "total_queue_wait": rep.total_queue_wait,
        "env_utilization": rep.env_utilization,
        "replicas": replicas,
        "replicated_bytes": rep.replicated_bytes,
        "promotions": rep.promotions,
        "races": rep.races,
        "race_waste_seconds": rep.race_waste_seconds,
        "replica_lag": {s.session: s.replica_lag for s in rep.sessions
                        if s.replica_lag},
        "sessions_per_modeled_hour": (
            n_sessions / rep.makespan * 3600 if rep.makespan else 0.0),
        "device": str(sched.device),
    }


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="demo-100m")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=48)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="cuda = the hand-written kernels (default), cpu = "
                         "their plain PyTorch versions; in the fleet and "
                         "gateway modes, where every session's digests, "
                         "chunk keys and quantization run")
    ap.add_argument("--notebook-fleet", type=int, default=0,
                    help="serve N concurrent notebook sessions instead of "
                         "an LM token batch")
    ap.add_argument("--fleet-gpu-capacity", type=int, default=2)
    ap.add_argument("--fleet-tpu-capacity", type=int, default=1)
    ap.add_argument("--gateway", type=int, default=None, metavar="N",
                    help="run the persistent multi-tenant gateway with N "
                         "programmatic sessions (0 = wire-only, see "
                         "--stress)")
    ap.add_argument("--tenants", default=None, metavar="SPEC",
                    help="comma list of name[:weight[:quota]] "
                         "(e.g. alice:2,bob:1:10)")
    ap.add_argument("--quota", type=int, default=None, metavar="N",
                    help="default per-tenant max concurrent sessions "
                         "(tenant spec quota overrides)")
    ap.add_argument("--warm-pool", type=int, default=8, metavar="K",
                    help="pre-provisioned workers held hot (0 = every "
                         "attach pays the cold start)")
    ap.add_argument("--max-sessions", type=int, default=None, metavar="N",
                    help="gateway-wide concurrent session cap")
    ap.add_argument("--stress", type=int, default=0, metavar="N",
                    help="drive N extra sessions as a Poisson attach storm "
                         "of real ATTACH frames over a wire frontend")
    ap.add_argument("--rate", type=float, default=50.0,
                    help="gateway storm arrival rate (sessions/s)")
    ap.add_argument("--replicas", type=int, default=0, metavar="K",
                    help="keep K follower namespaces converged per session "
                         "(fleet/gateway modes; 0 = off)")
    ap.add_argument("--race", choices=["on", "off"], default="off",
                    help="first-result-wins cell racing on converged "
                         "followers (requires --replicas >= 1)")
    args = ap.parse_args(argv)

    try:
        positive_int("--replicas", args.replicas, allow_zero=True)
        if args.race == "on" and not args.replicas:
            raise ValueError(
                "--race on races cells against converged followers and "
                "needs --replicas >= 1")
        if args.replicas and args.gateway is None \
                and not args.notebook_fleet:
            raise ValueError(
                "--replicas applies to --gateway or --notebook-fleet "
                "serving modes only")
    except ValueError as e:
        ap.error(str(e))

    if args.gateway is not None:
        try:
            tenants = (parse_tenant_spec(args.tenants)
                       if args.tenants else None)
            positive_int("--gateway", args.gateway, allow_zero=True)
            positive_int("--warm-pool", args.warm_pool, allow_zero=True)
            positive_int("--stress", args.stress, allow_zero=True)
            if args.quota is not None:
                positive_int("--quota", args.quota)
            if args.max_sessions is not None:
                positive_int("--max-sessions", args.max_sessions)
            if args.gateway == 0 and args.stress == 0:
                raise ValueError(
                    "--gateway 0 serves no one: give it N sessions or "
                    "add --stress N for a wire-borne storm")
        except ValueError as e:
            ap.error(str(e))
        report = serve_gateway(
            args.gateway, tenants=tenants, quota=args.quota,
            warm_pool=args.warm_pool, max_sessions=args.max_sessions,
            stress=args.stress, rate=args.rate, seed=args.seed,
            replicas=args.replicas, race=args.race == "on",
            device=args.device)
        print(json.dumps(report, indent=2))
        print("ok")
        return

    if args.notebook_fleet:
        report = serve_notebook_fleet(
            args.notebook_fleet, gpu_capacity=args.fleet_gpu_capacity,
            tpu_capacity=args.fleet_tpu_capacity,
            replicas=args.replicas, race=args.race == "on",
            device=args.device)
        print(json.dumps(report, indent=2))
        print("ok")
        return

    try:
        cfg = get_config(args.arch, reduced=args.reduced)
    except KeyError as e:
        ap.error(str(e))

    out = serve_lm(cfg, batch=args.batch, prompt_len=args.prompt_len,
                   gen=args.gen, seed=args.seed, device=args.device)
    ids = out["ids"]
    print(f"prefill {args.batch}x{args.prompt_len}: "
          f"{out['prefill_seconds']:.2f}s; decode {args.gen} tokens: "
          f"{out['decode_seconds']:.2f}s "
          f"({out['decode_tokens_per_s']:.1f} tok/s)")
    print("sample generated ids:", ids[0, :12].tolist())
    assert bool(np.all(ids >= 0)) and bool(np.all(ids < cfg.padded_vocab))
    print("ok")


if __name__ == "__main__":
    main()

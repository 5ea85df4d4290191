"""The port's placement rules and trees (``repro_torch.distributed``:
``make_rules``, ``DistContext.pspec``, ``params_shardings``,
``opt_shardings`` (ZeRO-1 and FSDP), ``batch_shardings`` and
``cache_shardings``) against the reference's, spec for spec, without
devices.

The reference runs on ``jax.sharding.AbstractMesh``, the port on the
mesh's ``{axis: size}``, for every config the registry names at full size,
on the production meshes (16, 16) and (2, 16, 16) and the dev mesh (2, 4),
in ``tp`` and ``fsdp`` mode.  A reference ``NamedSharding`` compares by its
spec as a tuple.  One case a (config, mesh, mode) for each tree, so that
each counts.

The layout test runs jax with 8 host devices in a subprocess (the test
process keeps jax's single device) and holds the block each device at a
(2, 4) mesh coordinate gets (``devices_indices_map``) against the local
shape and offset the port's placements give the rank at that coordinate.
"""
import functools
import json
import os
import subprocess
import sys
import textwrap

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from jax.sharding import AbstractMesh  # noqa: E402

from repro.configs import ShapeConfig as RefShapeConfig  # noqa: E402
from repro.configs import get_config as ref_config  # noqa: E402
from repro.distributed import sharding as ref_shd  # noqa: E402
from repro.distributed.context import DistContext as RefContext  # noqa: E402
from repro.distributed.steps import cache_specs as ref_cache_specs  # noqa: E402
from repro.distributed.steps import input_specs as ref_input_specs  # noqa: E402
from repro.models import LM as RefLM  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import ShapeConfig  # noqa: E402
from repro_torch.configs.registry import _ARCH_MODULES  # noqa: E402
from repro_torch.distributed import DistContext, make_rules, shard  # noqa: E402
from repro_torch.distributed import sharding as shd  # noqa: E402
from repro_torch.distributed.steps import input_specs  # noqa: E402
from repro_torch.models import LM  # noqa: E402
from repro_torch.models.layers import spec_leaves  # noqa: E402

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCHS = sorted(_ARCH_MODULES)
MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
          "2x4": ((2, 4), ("data", "model"))}
MODES = ("tp", "fsdp")
BATCHES = (1, 8, 256)
CASES = [(a, m, mode) for a in ARCHS for m in MESHES for mode in MODES]
cases = pytest.mark.parametrize("arch,mesh,mode", CASES)


@functools.lru_cache(maxsize=None)
def _models(arch):
    return RefLM(ref_config(arch)), LM(get_config(arch), device="cpu")


def _contexts(arch, mesh, mode, sp_decode=True):
    sizes, names = MESHES[mesh]
    ref = RefContext.create(ref_config(arch), AbstractMesh(sizes, names),
                            mode=mode, sp_decode=sp_decode)
    port = DistContext.create(get_config(arch), dict(zip(names, sizes)),
                              mode=mode, sp_decode=sp_decode)
    return ref, port


def _ref_specs(tree) -> dict:
    return {jax.tree_util.keystr(p): tuple(s.spec) for p, s in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


def _port_specs(tree) -> dict:
    return dict(spec_leaves(tree))


def _axes_in(tree) -> set:
    """Every logical-axes tuple of a (nested dict) axes tree."""
    if isinstance(tree, dict):
        return set().union(*(_axes_in(v) for v in tree.values()))
    return {tree}


def _same(got: dict, want: dict):
    assert sorted(got) == sorted(want)
    bad = {k: (got[k], want[k]) for k in want if got[k] != want[k]}
    assert not bad, bad


@cases
def test_rules_and_every_pspec_match_the_reference(arch, mesh, mode):
    """The rules dict, and the pspec of every logical-axes tuple of the
    params and of the cache (with and without sp_decode)."""
    ref_lm, lm = _models(arch)
    for sp in (True, False):
        rctx, ctx = _contexts(arch, mesh, mode, sp)
        sizes, names = MESHES[mesh]
        assert make_rules(get_config(arch), dict(zip(names, sizes)),
                          sp_decode=sp, mode=mode) == rctx.rules
        assert ctx.rules == rctx.rules and ctx.mode == rctx.mode == mode
        used = _axes_in(shd.axes_tree(lm.spec)) | _axes_in(
            lm.cache_axes(ctx))
        assert used == _axes_in(ref_lm.axes()) | _axes_in(
            ref_lm.cache_axes(rctx))
        for axes in used:
            assert ctx.pspec(axes) == tuple(rctx.pspec(axes)), axes


@cases
def test_param_placements_match_the_reference(arch, mesh, mode):
    ref_lm, lm = _models(arch)
    rctx, ctx = _contexts(arch, mesh, mode)
    want = _ref_specs(ref_shd.params_shardings(rctx, ref_lm.axes(),
                                               ref_lm.abstract()))
    got = _port_specs(shd.params_shardings(ctx, shd.axes_tree(lm.spec),
                                           shd.shapes_tree(lm.spec)))
    _same(got, want)


@cases
def test_optimizer_placements_match_the_reference(arch, mesh, mode):
    """ZeRO-1 in tp mode, FSDP in fsdp mode: step, m, v and master."""
    ref_lm, lm = _models(arch)
    rctx, ctx = _contexts(arch, mesh, mode)
    want = ref_shd.opt_shardings(rctx, ref_lm.axes(), ref_lm.abstract())
    got = shd.opt_shardings(ctx, shd.axes_tree(lm.spec),
                            shd.shapes_tree(lm.spec))
    assert got.step == tuple(want.step.spec) == ()
    for name in ("m", "v", "master"):
        _same(_port_specs(getattr(got, name)),
              _ref_specs(getattr(want, name)))


@cases
def test_batch_placements_match_the_reference(arch, mesh, mode):
    """Global batches 1 (replicated), 8 and 256, each input of a train,
    prefill and decode cell."""
    rcfg, cfg = ref_config(arch), get_config(arch)
    rctx, ctx = _contexts(arch, mesh, mode)
    for B in BATCHES:
        assert shd.batch_pspec(ctx, B) == ref_shd.batch_pspec(rctx, B)
        for kind in ("train", "prefill", "decode"):
            rshape = RefShapeConfig("t", kind, 64, B)
            shape = ShapeConfig("t", kind, 64, B)
            rin = ref_input_specs(rcfg, rshape)
            pin = input_specs(cfg, shape)
            assert {k: v.shape for k, v in pin.items()} == \
                {k: tuple(v.shape) for k, v in rin.items()}
            _same(_port_specs(shd.batch_shardings(ctx, pin, B)),
                  _ref_specs(ref_shd.batch_shardings(rctx, rin, B)))


@cases
def test_cache_placements_match_the_reference(arch, mesh, mode):
    """``cache_axes`` with and without sp_decode, at batches 1, 8 and 256;
    the port's cache leaves are the reference's (its host-side ``filled``
    count aside)."""
    ref_lm, lm = _models(arch)
    for sp in (True, False):
        rctx, ctx = _contexts(arch, mesh, mode, sp)
        for B in BATCHES:
            acache = ref_cache_specs(ref_lm, B, 32)
            want = _ref_specs(ref_shd.cache_shardings(
                rctx, ref_lm.cache_axes(rctx), acache, B))
            got = _port_specs(shd.cache_shardings(ctx, lm.cache_axes(ctx),
                                                  B))
            _same(got, want)


def test_the_port_cache_has_the_leaves_its_axes_name():
    """Reduced configs: ``LM.init_cache``'s tensor leaves are those of
    ``cache_axes``, each axes tuple as long as its leaf's rank."""
    for arch in ARCHS:
        lm = LM(get_config(arch, reduced=True), max_seq=32, device="cpu")
        lm.init(0, torch.float32)
        cache = lm.init_cache(2, 32)
        cache.pop("filled")
        leaves, axes = _port_specs(cache), _port_specs(lm.cache_axes())
        assert sorted(leaves) == sorted(axes), arch
        for k, t in leaves.items():
            assert t.dim() == len(axes[k]), (arch, k)


# ----------------------------------------------------------------------
# the layout: the port's shards at jax's index ranges
# ----------------------------------------------------------------------

LAYOUT_SHAPE = (8, 12, 16)
DM = ("data", "model")
LAYOUT_SPECS = [("data", None, None), (None, "model", None), (DM, None, None),
                (None, None, DM), ("model", "data", None),
                ("data", None, "model"), ()]


def _jax_blocks() -> list:
    code = f"""
        import json, jax, numpy as np
        from jax.sharding import Mesh, NamedSharding, PartitionSpec as PS
        devs = np.array(jax.devices()[:8]).reshape(2, 4)
        mesh = Mesh(devs, ("data", "model"))
        out = []
        shape = {LAYOUT_SHAPE!r}
        for spec in {LAYOUT_SPECS!r}:
            idx = NamedSharding(mesh, PS(*spec)).devices_indices_map(shape)
            out.append({{f"{{i}},{{j}}": [
                [s.start or 0, shape[d] if s.stop is None else s.stop]
                for d, s in enumerate(idx[devs[i, j]])]
                for i in range(2) for j in range(4)}})
        print(json.dumps(out))
    """
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    env["JAX_PLATFORMS"] = "cpu"
    r = subprocess.run([sys.executable, "-c", textwrap.dedent(code)],
                       capture_output=True, text=True, env=env, timeout=300)
    assert r.returncode == 0, r.stderr
    return json.loads(r.stdout.strip().splitlines()[-1])


def test_shards_lie_at_jax_index_ranges_on_a_2x4_mesh():
    """Leaves over 'data', 'model' and ('data', 'model') (major first), on
    each dim, and replicated: at every mesh coordinate the port's local
    shape and offset (DTensor's own computation for its placements) are
    the block jax gives that device."""
    from torch.distributed.tensor._utils import \
        _compute_local_shape_and_global_offset as local_block
    ctx = DistContext.create(get_config("yi-6b"), {"data": 2, "model": 4})
    want = _jax_blocks()
    for spec, blocks in zip(LAYOUT_SPECS, want):
        pl = ctx.placements(spec + (None,) * (3 - len(spec)))
        for i in range(2):
            for j in range(4):
                shape, offset = local_block(LAYOUT_SHAPE, (2, 4), [i, j], pl)
                got = [[o, o + n] for o, n in zip(offset, shape)]
                assert got == blocks[f"{i},{j}"], (spec, i, j, pl)
    with pytest.raises(ValueError, match="axis order"):
        ctx.placements((("model", "data"),))


def test_a_mapping_gives_the_axes_and_shard_is_the_identity():
    ctx = DistContext.create(get_config("yi-6b"), {"data": 2, "model": 1})
    assert ctx.axes == {"data": 2, "model": 1}
    assert ctx.pspec(("batch", None, "mlp")) == ("data", None, "model")
    x = torch.ones(3)
    assert shard(ctx, x, "batch") is x and shard(None, x) is x

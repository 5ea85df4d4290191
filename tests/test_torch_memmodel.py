"""The port's analytic memory model (``repro_torch.launch.memmodel``
``model_memory``) against the reference's, term for term, without
devices.

Every config the registry names, at full size, at every assigned shape
where ``shape_applicable`` lets it run (``train_4k``, ``prefill_32k``,
``decode_32k``, ``long_500k``), on the meshes of
``tests/test_torch_sharding.py`` ((16, 16), (2, 16, 16), (2, 4): the
reference's ``AbstractMesh``, the port's {axis: size}) in ``tp`` and
``fsdp`` mode, the train shapes at 1 and 4 microbatches.  Every key within
rtol 1e-12 (the near-exact floats of ROADMAP's slices; the terms are
summed in the same order, so they come out equal) and ``fits_hbm`` equal
at ``hbm_bytes=16e9``, the budget the reference compares with.  The
reference's numbers are computed once, in a module fixture; one case a
(config, mesh), so that each counts.
"""
import json
import os
import subprocess
import sys
import textwrap

import pytest

torch = pytest.importorskip("torch")

from jax.sharding import AbstractMesh  # noqa: E402

from repro.configs import TrainConfig as RefTrainConfig  # noqa: E402
from repro.configs import get_config as ref_config  # noqa: E402
from repro.configs.shapes import SHAPES as REF_SHAPES  # noqa: E402
from repro.distributed.context import DistContext as RefContext  # noqa: E402
from repro.launch.memmodel import model_memory as ref_model_memory  # noqa: E402
from repro.models import LM as RefLM  # noqa: E402
from repro_torch.configs import TrainConfig, get_config  # noqa: E402
from repro_torch.configs.registry import _ARCH_MODULES  # noqa: E402
from repro_torch.configs.shapes import SHAPES, shape_applicable  # noqa: E402
from repro_torch.distributed import DistContext  # noqa: E402
from repro_torch.launch.memmodel import model_memory  # noqa: E402
from repro_torch.models import LM  # noqa: E402

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCHS = sorted(_ARCH_MODULES)
MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
          "2x4": ((2, 4), ("data", "model"))}
MODES = ("tp", "fsdp")
HBM = 16e9
RTOL = 1e-12


def _cells(arch):
    """(shape name, mode, microbatches) of every case of one config."""
    cfg = get_config(arch)
    return [(s, mode, mb) for s in SHAPES
            if shape_applicable(cfg, SHAPES[s])[0]
            for mode in MODES
            for mb in ((1, 4) if SHAPES[s].kind == "train" else (1,))]


def _port(arch, mesh, shape, mode, mb):
    sizes, names = MESHES[mesh]
    cfg = get_config(arch)
    ctx = DistContext.create(cfg, dict(zip(names, sizes)), mode=mode)
    lm = LM(cfg, max_seq=SHAPES[shape].seq_len, device="cpu")
    return model_memory(cfg, SHAPES[shape], ctx,
                        TrainConfig(microbatches=mb), lm, hbm_bytes=HBM)


@pytest.fixture(scope="module")
def reference():
    out = {}
    for arch in ARCHS:
        cfg = ref_config(arch)
        for mesh, (sizes, names) in MESHES.items():
            for shape, mode, mb in _cells(arch):
                ctx = RefContext.create(cfg, AbstractMesh(sizes, names),
                                        mode=mode)
                lm = RefLM(cfg, max_seq=REF_SHAPES[shape].seq_len)
                out[arch, mesh, shape, mode, mb] = ref_model_memory(
                    cfg, REF_SHAPES[shape], ctx,
                    RefTrainConfig(microbatches=mb), lm)
    return out


@pytest.mark.parametrize("arch,mesh", [(a, m) for a in ARCHS
                                       for m in MESHES])
def test_model_memory_matches_the_reference(reference, arch, mesh):
    cells = _cells(arch)
    assert len(cells) >= 6
    for shape, mode, mb in cells:
        want = reference[arch, mesh, shape, mode, mb]
        got = _port(arch, mesh, shape, mode, mb)
        what = (arch, mesh, shape, mode, mb)
        assert list(got) == list(want), what
        assert got["fits_hbm"] == want["fits_hbm"], what
        for k, w in want.items():
            if k != "fits_hbm":
                assert got[k] == pytest.approx(w, rel=RTOL, abs=0), (what, k)


def test_the_shapes_that_run_are_the_references():
    """``long_500k`` only for the sub-quadratic families (mamba2,
    recurrentgemma), as the reference's applicability rule says."""
    from repro.configs.shapes import shape_applicable as ref_applicable
    for arch in ARCHS:
        for s in SHAPES:
            assert shape_applicable(get_config(arch), SHAPES[s])[0] == \
                ref_applicable(ref_config(arch), REF_SHAPES[s])[0]
    assert {a for a in ARCHS if shape_applicable(
        get_config(a), SHAPES["long_500k"])[0]} == {"mamba2-370m",
                                                    "recurrentgemma-9b"}


def test_fits_hbm_reads_the_budget_the_caller_passes():
    """No budget is built in: the same cell fits one budget and not a
    smaller one, and leaving the budget out is an error."""
    cfg = get_config("yi-6b")
    ctx = DistContext.create(cfg, {"data": 2, "model": 4})
    lm = LM(cfg, max_seq=SHAPES["decode_32k"].seq_len, device="cpu")
    tc = TrainConfig()
    mm = model_memory(cfg, SHAPES["decode_32k"], ctx, tc, lm,
                      hbm_bytes=80e9)
    total = mm["total"]
    assert model_memory(cfg, SHAPES["decode_32k"], ctx, tc, lm,
                        hbm_bytes=total)["fits_hbm"]
    assert not model_memory(cfg, SHAPES["decode_32k"], ctx, tc, lm,
                            hbm_bytes=total * (1 - 1e-9))["fits_hbm"]
    with pytest.raises(TypeError):
        model_memory(cfg, SHAPES["decode_32k"], ctx, tc, lm)


def test_the_largest_cache_is_computed_without_allocating():
    """qwen3-moe-235b-a22b at ``decode_32k`` on (2, 16, 16): a cache of
    hundreds of GB (and 470 GB of parameters) summed from shapes alone,
    in a fresh process (torch and the port only), whose peak resident
    memory grows by less than 100 MB across the call."""
    code = textwrap.dedent("""
        import json, resource, sys
        from repro_torch.configs import TrainConfig, get_config
        from repro_torch.configs.shapes import SHAPES
        from repro_torch.distributed import DistContext
        from repro_torch.launch.memmodel import model_memory
        from repro_torch.models import LM
        cfg = get_config("qwen3-moe-235b-a22b")
        shape = SHAPES["decode_32k"]
        ctx = DistContext.create(cfg, {"pod": 2, "data": 16, "model": 16})
        lm = LM(cfg, max_seq=shape.seq_len, device="cpu")
        before = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
        mm = model_memory(cfg, shape, ctx, TrainConfig(), lm, hbm_bytes=16e9)
        after = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
        print(json.dumps({"kib": after - before, "mm": mm,
                          "jax": "jax" in sys.modules}))
    """)
    env = dict(os.environ, PYTHONPATH=os.path.join(_REPO, "src"))
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, env=env, timeout=120)
    assert r.returncode == 0, r.stderr[-4000:]
    got = json.loads(r.stdout.strip().splitlines()[-1])
    assert not got["jax"]
    assert got["kib"] * 1024 < 100e6, got
    # the whole cache, before sharding, is hundreds of GB
    cfg = get_config("qwen3-moe-235b-a22b")
    shape = SHAPES["decode_32k"]
    whole = (2 * cfg.num_layers * shape.global_batch * cfg.num_kv_heads
             * shape.seq_len * cfg.resolved_head_dim * 2)
    assert whole > 100e9 and got["mm"]["cache"] > 0

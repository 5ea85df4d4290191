"""The port's LM server on the CPU: the CLI, the reference's greedy
ids for the same seed and weights, the serving modes against the
reference's server, and the families it rejects."""
import json
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as ref_config  # noqa: E402
from repro.configs.base import ShapeConfig as RefShape  # noqa: E402
from repro.data import TokenPipeline as RefPipeline  # noqa: E402
from repro.models import LM as RefLM  # noqa: E402
from repro.launch import serve as ref_serve  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch import serve  # noqa: E402

BATCH, PROMPT, GEN, SEED = 2, 48, 6, 5


def _reference_ids(arch):
    """The reference server's greedy loop (``repro/launch/serve.py``) with
    f32 weights; returns (ids, the weights as numpy arrays)."""
    cfg = ref_config(arch, reduced=True)
    lm = RefLM(cfg, max_seq=PROMPT + GEN)
    pipe = RefPipeline(cfg, RefShape("cli", "prefill", PROMPT, BATCH), seed=SEED)
    batch = {k: jnp.asarray(v) for k, v in pipe.prefill_batch(0).items()}
    params = lm.init(jax.random.PRNGKey(SEED), jnp.float32)
    logits, cache = lm.prefill(params, batch, cache_len=PROMPT + GEN)
    toks = []
    tok = jnp.argmax(logits, axis=-1)[:, None].astype(jnp.int32)
    for _ in range(GEN):
        toks.append(tok)
        logits, cache = lm.decode_step(params, cache, {"token": tok})
        tok = jnp.argmax(logits, axis=-1)[:, None].astype(jnp.int32)
    return (np.asarray(jnp.concatenate(toks, axis=1)),
            jax.tree_util.tree_map(np.asarray, params), batch["tokens"])


@pytest.mark.parametrize("arch", ["yi-6b", "mamba2-370m", "recurrentgemma-9b"])
def test_serve_lm_gives_the_reference_ids(arch):
    want, params, prompt = _reference_ids(arch)
    out = serve.serve_lm(get_config(arch, reduced=True), batch=BATCH,
                         prompt_len=PROMPT, gen=GEN, seed=SEED, device="cpu",
                         params=params)
    np.testing.assert_array_equal(out["prompt"], np.asarray(prompt))
    np.testing.assert_array_equal(out["ids"], want)
    assert out["device"] == "cpu" and out["prefill_seconds"] > 0


@pytest.mark.parametrize("arch", ["yi-6b", "mamba2-370m", "recurrentgemma-9b"])
def test_cli_serves_on_the_cpu(arch, capsys):
    serve.main(["--arch", arch, "--reduced", "--device", "cpu",
                "--batch", "2", "--gen", "4"])
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("prefill 2x48: ") and "tok/s" in out[0]
    assert out[1].startswith("sample generated ids: [")
    assert out[-1] == "ok"


@pytest.mark.parametrize("flag", [["--notebook-fleet", "8"], ["--gateway", "4"],
                                  ["--replicas", "1"],
                                  ["--gateway", "0", "--stress", "10"]])
def test_cli_names_the_options_not_ported_yet(flag, capsys, monkeypatch):
    """The serving modes the port once turned away are ported: each command
    line runs (its report equal to the reference's) or is refused exactly
    as the reference's server does it."""
    from test_torch_notebook_cli import assert_reports_agree

    def run(main, argv):
        monkeypatch.setattr(sys, "argv", ["serve", *argv])
        try:
            main()
        except SystemExit as e:
            out = capsys.readouterr()
            return e.code, out.err.strip().splitlines()[-1]
        out = capsys.readouterr().out.strip().splitlines()
        assert out[-1] == "ok"
        return 0, json.loads("\n".join(out[:-1]))

    want = run(ref_serve.main, flag)
    got = run(lambda: serve.main([*flag, "--device", "cpu"]), flag)
    assert got[0] == want[0]
    if want[0]:
        assert got[1] == want[1] and "error:" in got[1]
    else:
        assert_reports_agree(got[1], want[1])


@pytest.mark.parametrize("arch,family", [
    ("qwen2-moe-a2.7b", "moe"), ("whisper-tiny", "encdec"),
    ("internvl2-2b", "vlm")])
def test_cli_names_the_families_not_ported_yet(arch, family, capsys):
    with pytest.raises(SystemExit) as e:
        serve.main(["--arch", arch, "--reduced", "--device", "cpu"])
    assert e.value.code == 2
    err = capsys.readouterr().err
    assert f"family {family!r}" in err and "ROADMAP A9" in err


def test_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="cuda"):
        serve.main(["--arch", "yi-6b", "--reduced"])

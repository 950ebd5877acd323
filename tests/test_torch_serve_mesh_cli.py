"""The port's serving entry points on a mesh against one process, on the CPU
at the smoke size: ``serve(mesh=)`` on (1, 2, 2) gloo ranks, ``python -m
repro_torch.launch.serve --mesh P,D,M`` (its ``main`` on gloo ranks, as
``torchrun`` would start it) and ``examples/serve_decode_torch.py`` on 8
local ranks, (2, 2, 2).

``serve(mesh=)`` in f32 compute decodes the tokens one process decodes,
bit for bit (the split sums differ from one process' in their last bits,
and no greedy choice of these prompts lies that near a tie).  In bf16, as
the CLI and the example decode, the split sums round otherwise than one
process'.  These bounds are chip_smoke's for bf16 decode:
``BF16_REL`` (2e-2, its ``DECODE_TOL["bfloat16"]``) of the largest logit,
or of 1 where every logit is smaller (its ``_rel``; the smoke models'
logits are below 1):

* the mesh's bf16 logits, fed one process' tokens, are within that of one
  process' (at most 1.2e-2 on the six archs here, where each side's bf16
  logits lie up to 1.3e-2 from the f32 logits: one process is no nearer
  f32 than the mesh);
* each token the CLI or the example prints is one process' greedy choice
  when one process is fed the same tokens before it, or its logit lies
  within that of the step's maximum (a near tie), and every rank returns
  the same tokens;
* an encoder's bf16 logits are within that of one process'.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs.registry import get_smoke_config
from repro_torch.dist.sharding import batch_rows
from repro_torch.launch import serve as serve_mod
from repro_torch.launch.mesh import make_mesh, run_local_ranks
from repro_torch.models.model import cast_params_
from repro_torch.train.train_step import TrainConfig, build_serve_step, init_local_cache

REPO = Path(__file__).resolve().parents[1]
RANK_TIMEOUT = 300
F32, BF16 = TrainConfig(compute_dtype=torch.float32), TrainConfig()
BF16_REL = 2e-2
MESH = (1, 2, 2)
BATCH, PROMPT, GEN = 4, 8, 6
SERVED = ["minitron-8b", "granite-moe-3b-a800m", "llama-3.2-vision-90b", "deepseek-v3-671b",
          "recurrentgemma-9b", "rwkv6-7b"]


def inputs(cfg, batch: int = BATCH, prompt: int = PROMPT):
    return (serve_mod.make_prompts(cfg, batch, prompt, seed=0),
            serve_mod.make_image(cfg, batch, prompt, seed=0))


def forced_logits(cfg, prompts: np.ndarray, img, tokens: np.ndarray, tcfg: TrainConfig,
                  mesh=None) -> np.ndarray:
    """``serve()``'s flow fed ``tokens`` (B, gen) in place of its own
    greedy choices: (rows, gen, vocab) f32 logits of this rank's rows (all
    rows in one process), ``[:, 0]`` the prefill's last position (f32
    compute), ``[:, t]`` the decode step fed ``tokens[:, t - 1]`` in
    ``tcfg.compute_dtype``, the weights cast in place after the prefill as
    ``serve()`` casts them."""
    b, p = prompts.shape
    own = slice(0, b) if mesh is None else batch_rows(mesh.shape, mesh.coords, b)
    extra = {} if img is None else {"img": torch.from_numpy(img[own])}
    params = serve_mod.init_model(cfg, tcfg, 0, "cpu")
    prefill = build_serve_step(cfg, F32, kind="decode", device="cpu", mesh=mesh)
    cache = init_local_cache(cfg, b, p + tokens.shape[1], {} if mesh is None else mesh.shape,
                             torch.float32, "cpu")
    logits, cache = prefill.logits(
        params, cache, {"tokens": torch.from_numpy(prompts[own]), **extra}, rows=b)
    out = [logits[:, -1].float()]
    cast_params_(params, tcfg.compute_dtype)
    step = build_serve_step(cfg, tcfg, kind="decode", device="cpu", mesh=mesh)
    for t in range(tokens.shape[1] - 1):
        logits, cache = step.logits(
            params, cache, {"tokens": torch.from_numpy(tokens[own, t:t + 1]), **extra}, rows=b)
        out.append(logits[:, -1].float())
    return torch.stack(out, 1).numpy()


def scale(logits: np.ndarray) -> float:
    """What ``BF16_REL`` is relative to: the largest |logit|, at least 1."""
    return max(1.0, float(np.abs(logits).max()))


def off_greedy(tokens: np.ndarray, logits: np.ndarray) -> list[str]:
    """The tokens that are neither the greedy choice of ``logits`` (one
    process fed ``tokens``) nor within ``BF16_REL`` (of ``scale``) of the
    step's maximum."""
    bad = []
    for r, t in np.ndindex(tokens.shape):
        row = logits[r, t]
        gap = row.max() - row[tokens[r, t]]
        if gap > BF16_REL * scale(row):
            bad.append(f"row {r} step {t}: token {tokens[r, t]} is {gap:.3e} below the "
                       f"greedy {row.argmax()}, largest |logit| {np.abs(row).max():.3e}")
    return bad


def serve_rank(rank: int, archs: list[str], want16: dict) -> dict:
    """``serve(mesh=)`` in f32 for each arch, and the bf16 flow on the mesh
    fed one process' bf16 tokens ``want16[arch]``: this rank's rows'
    logits."""
    mesh, _ = make_mesh(MESH, device="cpu")
    out = {"coords": dict(mesh.coords)}
    for arch in archs:
        cfg = get_smoke_config(arch)
        prompts, img = inputs(cfg)
        res = serve_mod.serve(cfg, serve_mod.init_model(cfg, F32, 0, "cpu"), prompts, GEN, F32,
                              "cpu", img, mesh)
        out[arch] = {"f32": res.tokens,
                     "bf16": forced_logits(cfg, prompts, img, want16[arch], BF16, mesh)}
    return out


@pytest.fixture(scope="module")
def served():
    """One process' f32 tokens, bf16 tokens and bf16 logits fed them, by
    arch; the mesh ranks' results."""
    one = {}
    for arch in SERVED:
        cfg = get_smoke_config(arch)
        prompts, img = inputs(cfg)
        f32 = serve_mod.serve(cfg, serve_mod.init_model(cfg, F32, 0, "cpu"), prompts, GEN, F32,
                              "cpu", img).tokens
        bf16 = serve_mod.serve(cfg, serve_mod.init_model(cfg, BF16, 0, "cpu"), prompts, GEN,
                               BF16, "cpu", img).tokens
        one[arch] = {"f32": f32, "bf16": bf16,
                     "logits": forced_logits(cfg, prompts, img, bf16, BF16)}
    ranks = run_local_ranks(serve_rank, 4, (SERVED, {a: one[a]["bf16"] for a in SERVED}),
                            timeout=RANK_TIMEOUT)
    return one, ranks


@pytest.mark.parametrize("arch", SERVED)
def test_serve_on_a_mesh_matches_one_process(arch, served):
    """``serve(mesh=)`` on (1, 2, 2), f32 compute: every rank returns every
    row's tokens, those one process decodes; in bf16, each rank's rows'
    logits fed one process' tokens are one process' within ``BF16_REL``."""
    one, ranks = served
    sizes = dict(zip(("pod", "data", "model"), MESH))
    for got in ranks:
        np.testing.assert_array_equal(got[arch]["f32"], one[arch]["f32"])
        want = one[arch]["logits"][batch_rows(sizes, got["coords"], BATCH)]
        for t in range(GEN):
            err = float(np.abs(got[arch]["bf16"][:, t] - want[:, t]).max())
            assert err <= BF16_REL * scale(want[:, t]), (got["coords"], t, err)


def cli_rank(rank: int, argv: list[str]):
    res = serve_mod.main(argv)
    return res.tokens if hasattr(res, "tokens") else res.logits.float().numpy()


@pytest.mark.parametrize("arch", ["minitron-8b", "granite-moe-3b-a800m", "hubert-xlarge"])
def test_serve_cli_on_a_mesh_matches_one_process(arch, capsys):
    """``main --mesh 1,2,2`` (bf16 decode): 4 prompts, a data rank's 2
    rows, heads (and granite's experts, no drop at the smoke config's
    capacity factor) split over model; every rank returns the same rows,
    in the vocabulary, each token one process' greedy choice fed the same
    tokens or at a near tie; an encoder's logits one process'."""
    argv = ["--arch", arch, "--smoke", "--device", "cpu", "--batch", str(BATCH),
            "--prompt-len", str(PROMPT), "--gen-len", str(GEN)]
    ranks = run_local_ranks(cli_rank, 4, (argv + ["--mesh", "1,2,2"],), timeout=RANK_TIMEOUT)
    cfg = get_smoke_config(arch)
    for got in ranks:
        np.testing.assert_array_equal(got, ranks[0])
    if cfg.is_encoder_only:
        one = cli_rank(0, argv)
        assert ranks[0].shape == one.shape
        assert np.abs(ranks[0] - one).max() <= BF16_REL * scale(one)
    else:
        gen = ranks[0]
        assert gen.shape == (BATCH, GEN)
        assert ((gen >= 0) & (gen < cfg.vocab_size)).all()
        prompts, img = inputs(cfg)
        bad = off_greedy(gen, forced_logits(cfg, prompts, img, gen, BF16))
        assert not bad, "\n".join(bad)
    with pytest.raises(SystemExit):
        serve_mod.main(argv + ["--mesh", "1,2,2"])      # 4 ranks asked for, a world of 1
    assert "holds 4 ranks, the world has 1" in capsys.readouterr().err


@pytest.mark.parametrize("arch", ["minitron-8b", "llama-3.2-vision-90b"])
def test_serve_decode_example_on_8_ranks_matches_one_process(arch):
    """The example on (2, 2, 2), bf16 decode: it checks that the ranks
    gathered the same tokens, in the vocabulary; each is one process'
    greedy choice fed the same tokens from the same seeded weights, prompts
    and image (the image with the prefill too), or at a near tie."""
    gen = 6
    run = subprocess.run([sys.executable, str(REPO / "examples" / "serve_decode_torch.py"),
                          "--arch", arch, "--device", "cpu", "--gen-len", str(gen)],
                         env=dict(os.environ, PYTHONPATH=str(REPO / "src")),
                         capture_output=True, text=True, timeout=RANK_TIMEOUT)
    assert run.returncode == 0, run.stderr[-4000:]
    line = [ln for ln in run.stdout.splitlines() if ln.startswith("tokens: ")]
    got = np.array(json.loads(line[0][len("tokens: "):]), dtype=np.int32)
    assert got.shape == (8, gen)
    cfg = get_smoke_config(arch)
    prompts, img = inputs(cfg, 8, 24)
    bad = off_greedy(got, forced_logits(cfg, prompts, img, got, BF16))
    assert not bad, "\n".join(bad)

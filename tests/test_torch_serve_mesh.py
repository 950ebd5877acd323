"""Serving on a mesh (``build_serve_step(mesh=)``, ``launch.serve.serve`` and
``encode`` with ``mesh=``) against the reference's ``build_serve_step(cfg,
mesh, tcfg)`` on the CPU, at the smoke size.

The reference runs in a child process with 8 forced host devices, its
meshes built with ``Auto`` axes (fault 1), and writes:

* the partition specs ``_cache_shardings`` gives every leaf of every
  arch's decode cache (full configs, abstract shapes) on (1, 2, 2), (2, 2,
  2), (1, 1, 2) and (2, 1, 1), for 64, 8193 (odd: the sequence does not
  split) and 8200 positions, batches of 8 and 2;
* per decode case, from the jittered weights of ``test_torch_dense_serve``
  and numpy prompts: its decode step jitted on the case's mesh (in f32
  compute on an f32 cache) run over the prompt (the cached prefill under
  the mesh, in the case's chunks), then ``STEPS`` greedy steps; the tokens
  and the last cache;
* hubert-xlarge's prefill step (``kind="prefill"``) on (1, 2, 2).

The port runs every case of a mesh in one spawn of gloo ranks
(``launch.mesh.run_local_ranks``): each rank prefills and decodes its rows
on its part of the cache (``train_step.init_local_cache``), fed the
reference's tokens.  Checked: every rank's next tokens are the
reference's (where a step's top two logits lie within ``TIE`` of the
largest logit, that the reference's token is one of the two), and every
cache leaf, gathered whole from the ranks, within ``CACHE_REL`` of its
largest value (f32: the heads' and ranks' sums run in other orders); ranks
that hold the same block hold the same bits.  Hubert's logits within
``CACHE_REL`` of the largest.  ``test_torch_serve_mesh_long.py`` holds the
caches split along their sequence with the helpers here.

Also: ``launch.serve.main --mesh`` and ``examples/serve_decode_torch.py``
against one process, in f32 compute (in bf16 the split sums round
otherwise, and the smoke models' greedy tokens flip on near ties).
"""

import contextlib
import dataclasses
import json
import math
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs.registry import ARCHS, get_config, get_smoke_config
from repro_torch.dist.context import DistContext
from repro_torch.dist.sharding import batch_rows
from repro_torch.launch import serve as serve_mod
from repro_torch.launch.mesh import AXES, make_mesh, run_local_ranks
from repro_torch.models.convert import _jax_location, params_from_jax
from repro_torch.models.model import init_cache
from repro_torch.train.train_step import (TrainConfig, build_serve_step, cache_specs,
                                          init_local_cache)
from repro_torch.tree import leaf_paths

REPO = Path(__file__).resolve().parents[1]
RANK_TIMEOUT = 300
STEPS = 4
CACHE_REL, TIE = 1e-5, 1e-5
F32 = TrainConfig(compute_dtype=torch.float32)
SPEC_MESHES = [(1, 2, 2), (2, 2, 2), (1, 1, 2), (2, 1, 1)]
SPEC_LENGTHS = [64, 8193, 8200]
SPEC_BATCHES = [8, 2]


@dataclasses.dataclass(frozen=True)
class Case:
    """A decode case: ``arch``'s smoke config (at ``capacity`` where given)
    on ``mesh``, ``batch`` rows, a prompt of ``prompt`` tokens prefilled in
    chunks of ``chunk`` (one piece by default), a cache of ``max_len``
    positions (by default the prompt and the steps), ``STEPS`` decode
    steps; with ``mutations`` the decode is repeated from the prefilled
    cache under each of ``MUTATIONS``."""

    name: str
    arch: str
    mesh: tuple
    batch: int = 4
    prompt: int = 9
    max_len: int | None = None
    chunk: int | None = None
    capacity: float | None = None
    mutations: bool = False

    @property
    def length(self) -> int:
        return self.max_len or self.prompt + STEPS + 1


CASES = [
    Case("minitron-8b on 1x2x2", "minitron-8b", (1, 2, 2)),
    Case("minitron-8b on 2x2x2", "minitron-8b", (2, 2, 2)),
    Case("granite-moe-3b-a800m at 1.25", "granite-moe-3b-a800m", (1, 2, 2), capacity=1.25),
    Case("granite-moe-3b-a800m, no drop", "granite-moe-3b-a800m", (1, 2, 2)),
    # model 1: the dense dispatch routes the pod's rows, each data rank's
    # queues after the ranks' before it (DistContext.rows_before)
    Case("granite-moe-3b-a800m at 1.25 on 1x2x1", "granite-moe-3b-a800m", (1, 2, 1),
         capacity=1.25),
    Case("llama-3.2-vision-90b with its image", "llama-3.2-vision-90b", (1, 2, 2)),
    # a ring of 32 entries: a prompt of 30, so that the decode wraps it
    Case("recurrentgemma-9b, the ring", "recurrentgemma-9b", (1, 2, 2), prompt=30),
    # f32 compute: the reference's bf16 decode over an f32 cache raises (fault 13)
    Case("rwkv6-7b", "rwkv6-7b", (2, 2, 2)),
]
HUBERT = "hubert-xlarge"
HUBERT_MESH, HUBERT_SHAPE = (1, 2, 2), (4, 16)


def mesh_key(shape) -> str:
    return "x".join(map(str, shape))


def port_config(case: Case):
    cfg = get_smoke_config(case.arch)
    if case.capacity is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe,
                                                                capacity_factor=case.capacity))
    return cfg


def case_inputs(case: Case, cfg) -> tuple[np.ndarray, np.ndarray | None]:
    """The prompts (batch, prompt) and, for a VLM, the image context, from
    numpy with the case's own seed."""
    rng = np.random.default_rng(sum(map(ord, case.name)))
    prompts = rng.integers(0, cfg.vocab_size, (case.batch, case.prompt)).astype(np.int32)
    img = None
    if cfg.n_img_tokens:
        img = rng.normal(0, 1, (case.batch, cfg.n_img_tokens, cfg.d_model)).astype(np.float32)
    return prompts, img


def hubert_frames(cfg) -> np.ndarray:
    return np.random.default_rng(3).normal(0, 1, (*HUBERT_SHAPE, cfg.d_model)).astype(np.float32)


def norm_spec(spec) -> tuple:
    """A partition spec as a tuple of axis-name tuples (``()`` for an
    unsplit dim), trailing unsplit dims dropped: ``P(None, None)`` is
    ``P()``."""
    out = [() if e is None else (e,) if isinstance(e, str) else tuple(e) for e in spec]
    while out and out[-1] == ():
        out.pop()
    return tuple(out)


# ---------------------------------------------------------------------------
# the reference, in a child process (run as ``python this_file.py reference``)
# ---------------------------------------------------------------------------


def mesh_of(shape):
    import jax
    from jax.sharding import AxisType

    return jax.make_mesh(shape, AXES, axis_types=(AxisType.Auto,) * 3,
                         devices=jax.devices()[:math.prod(shape)])


def flat(tree, prefix: str) -> dict[str, np.ndarray]:
    import jax

    return {prefix + "/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path):
            np.asarray(v) for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def reference_specs() -> dict:
    """``_cache_shardings``' specs of every arch's cache, keyed
    ``arch/mesh/max_len/batch``, each leaf's normalised."""
    import jax
    import jax.numpy as jnp

    from repro.configs.registry import get_config as jax_config
    from repro.models import model as jax_model
    from repro.train import train_step as jts

    out = {}
    for shape in SPEC_MESHES:
        mesh = mesh_of(shape)
        for arch in ARCHS:
            jcfg = jax_config(arch)
            for max_len in SPEC_LENGTHS:
                for batch in SPEC_BATCHES:
                    tree = jax.eval_shape(lambda: jax_model.init_cache(jcfg, batch, max_len,
                                                                       jnp.float32))
                    specs = jts._cache_shardings(tree, mesh)
                    out[f"{arch}/{mesh_key(shape)}/{max_len}/{batch}"] = {
                        key: [list(e) for e in norm_spec(v.spec)]
                        for key, v in flat_specs(specs).items()}
    return out


def flat_specs(tree) -> dict:
    import jax

    paths = jax.tree_util.tree_flatten_with_path(tree, is_leaf=lambda x: hasattr(x, "spec"))[0]
    return {"/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path): v
            for path, v in paths}


def reference_decode(case: Case) -> dict[str, np.ndarray]:
    """The case's initial parameters, the reference's tokens (batch, 1 +
    STEPS) and its last cache, through its decode step on the mesh."""
    import jax
    import jax.numpy as jnp

    import repro.dist  # noqa: F401  (installs jax.shard_map on old JAX)
    from repro.configs.registry import get_smoke_config as jax_smoke
    from repro.models import model as jax_model
    from repro.train import train_step as jts
    from test_torch_dense_serve import jax_tree

    jcfg = jax_smoke(case.arch)
    if case.capacity is not None:
        jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(jcfg.moe,
                                                                  capacity_factor=case.capacity))
    tree = jax_tree(jcfg, 7)
    params = jax.tree.map(jnp.asarray, tree)
    prompts, img = case_inputs(case, jcfg)
    extra = {} if img is None else {"img": jnp.asarray(img)}
    make_jit, _ = jts.build_serve_step(jcfg, mesh_of(case.mesh),
                                       jts.TrainConfig(compute_dtype=jnp.float32), kind="decode")
    steps = {}

    def run(cache, batch):
        shape = tuple(batch["tokens"].shape)
        if shape not in steps:
            steps[shape] = make_jit(cache, batch)
        return steps[shape](params, cache, batch)

    cache = jax_model.init_cache(jcfg, case.batch, case.length, dtype=jnp.float32)
    chunk = case.chunk or case.prompt
    for start in range(0, case.prompt, chunk):
        tok, cache = run(cache, {"tokens": jnp.asarray(prompts[:, start:start + chunk]), **extra})
    toks = [tok]
    for _ in range(STEPS):
        tok, cache = run(cache, {"tokens": tok[:, None], **extra})
        toks.append(tok)
    out = flat(tree, f"{case.name}/init/")
    out[f"{case.name}/tokens"] = np.stack([np.asarray(t) for t in toks], axis=1)
    out.update(flat(cache, f"{case.name}/cache/"))
    return out


def reference_hubert() -> dict[str, np.ndarray]:
    import jax
    import jax.numpy as jnp

    from repro.configs.registry import get_smoke_config as jax_smoke
    from repro.train import train_step as jts
    from test_torch_dense_serve import jax_tree

    jcfg = jax_smoke(HUBERT)
    tree = jax_tree(jcfg, 7)
    make_jit, _ = jts.build_serve_step(jcfg, mesh_of(HUBERT_MESH),
                                       jts.TrainConfig(compute_dtype=jnp.float32), kind="prefill")
    batch = {"embeds": jnp.asarray(hubert_frames(jcfg))}
    logits = make_jit(batch)(jax.tree.map(jnp.asarray, tree), batch)
    return {**flat(tree, f"{HUBERT}/init/"), f"{HUBERT}/logits": np.asarray(logits)}


def reference_main(out_dir: str) -> None:
    out = reference_hubert()
    for case in CASES:
        out.update(reference_decode(case))
    np.savez(os.path.join(out_dir, "reference.npz"), **out)
    with open(os.path.join(out_dir, "specs.json"), "w") as f:
        json.dump(reference_specs(), f)


def run_reference(tmp_path_factory, test_file: str) -> dict:
    """Run ``test_file``'s ``reference_main`` in a child process with 8
    forced host devices; its arrays, and its specs under ``"specs"`` where
    it wrote them."""
    out_dir = tmp_path_factory.mktemp("reference")
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=8",
               JAX_PLATFORMS="cpu", PYTHONPATH=str(REPO / "src"))
    run = subprocess.run([sys.executable, test_file, "reference", str(out_dir)], env=env,
                         capture_output=True, text=True, timeout=600)
    assert run.returncode == 0, run.stderr[-4000:]
    out = dict(np.load(out_dir / "reference.npz"))
    if (out_dir / "specs.json").exists():
        out["specs"] = json.loads((out_dir / "specs.json").read_text())
    return out


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    return run_reference(tmp_path_factory, __file__)


def sub(runs: dict, prefix: str) -> dict:
    return {k[len(prefix):]: v for k, v in runs.items() if k.startswith(prefix)}


# ---------------------------------------------------------------------------
# the port, on gloo ranks
# ---------------------------------------------------------------------------


MUTATIONS = ("a zeroed model-rank-1 shard", "a merge that drops the last model rank")


def zero_model_rank(cache, coord: int, model_rank: int = 1):
    """``cache`` with every layer's leaves that are split along the
    sequence zeroed, on ``model`` rank ``model_rank`` (this rank is at
    ``coord``)."""
    if coord != model_rank:
        return cache
    return {"layers": [{k: torch.zeros_like(v) if isinstance(v, torch.Tensor) else v
                        for k, v in layer.items()} if layer.get("seq_shards", 1) > 1 else layer
                       for layer in cache["layers"]]}


@contextlib.contextmanager
def dropping_last_rank():
    """The sequence split's merge without the last ``model`` rank's part."""
    real = DistContext.gather_model
    DistContext.gather_model = lambda self, x: real(self, x)[:-1]
    try:
        yield
    finally:
        DistContext.gather_model = real


def decode(step, params, cache, tokens: np.ndarray, extra: dict, coord: int,
           rows: int, mutation: str | None = None):
    """``STEPS`` decode steps fed ``tokens[:, t]`` (this rank's rows of
    ``rows``), each step's last-position logits, and the cache."""
    lasts = []
    for t in range(STEPS):
        if mutation == MUTATIONS[0]:
            cache = zero_model_rank(cache, coord)
        batch = {"tokens": torch.from_numpy(np.ascontiguousarray(tokens[:, t:t + 1])), **extra}
        if mutation == MUTATIONS[1]:
            with dropping_last_rank():
                logits, cache = step.logits(params, cache, batch, rows=rows)
        else:
            logits, cache = step.logits(params, cache, batch, rows=rows)
        lasts.append(logits[:, -1].float())
    return lasts, cache


def decode_case(case: Case, mesh, init: dict, tokens: np.ndarray) -> dict:
    """The port's side of ``reference_decode`` on this rank: its rows'
    last-position logits of the prefill and of every step (rows, 1 +
    STEPS, vocab), its cache's leaves and lengths; with
    ``case.mutations`` the decode's logits and cache again from the
    prefilled cache under each mutation."""
    cfg = port_config(case)
    params = params_from_jax(cfg, init, device="cpu")
    prompts, img = case_inputs(case, cfg)
    own = batch_rows(mesh.shape, mesh.coords, case.batch)
    prompts, tokens = prompts[own], tokens[own]
    extra = {} if img is None else {"img": torch.from_numpy(img[own])}
    step = build_serve_step(cfg, F32, kind="decode", device="cpu", mesh=mesh)
    cache = init_local_cache(cfg, case.batch, case.length, mesh.shape, torch.float32, "cpu")
    chunk = case.chunk or case.prompt
    for start in range(0, case.prompt, chunk):
        logits, cache = step.logits(
            params, cache, {"tokens": torch.from_numpy(prompts[:, start:start + chunk]), **extra},
            rows=case.batch)
    first = logits[:, -1].float()
    coord = mesh.coords["model"]
    lasts, last_cache = decode(step, params, cache, tokens, extra, coord, case.batch)
    out = {"coords": dict(mesh.coords), "logits": torch.stack([first, *lasts], 1).numpy(),
           "cache": {k: v.numpy() if isinstance(v, torch.Tensor) else v
                     for k, v in leaf_paths(last_cache)},
           "merge_bytes": step.ctx.merge_bytes}
    if case.mutations:
        for mutation in MUTATIONS:
            got, bad_cache = decode(step, params, cache, tokens, extra, coord, case.batch,
                                    mutation)
            out[mutation] = {"logits": torch.stack([first, *got], 1).numpy(),
                             "cache": {k: v.numpy() if isinstance(v, torch.Tensor) else v
                                       for k, v in leaf_paths(bad_cache)}}
    return out


def warm_vector_math() -> None:
    """Call the vectorised math the cases use (cos, sin, exp) once in this
    fresh process before the cases run, a precaution.  On a loaded host a
    rank's first RoPE was once seen off by ~5e-5 of each value at positions
    1-512 of its first prefill chunk (the same call again, or the k rotated
    just after, exact), which moved minitron's layer-1 cache by 1.3e-4 of
    its largest value.  Its cause is unconfirmed (a first call of MKL's
    vector math was suspected): loaded reruns of both mesh files' ranks,
    with and without this call, and fresh processes rotating the same q
    have not shown it again."""
    x = torch.linspace(0.0, 600.0, 1 << 16)
    torch.cos(x), torch.sin(x), torch.exp(-x)


def mesh_rank(rank: int, shape: tuple, cases: list, inits: dict, tokens: dict,
              hubert: dict | None = None) -> dict:
    """Every case of ``shape`` on this rank, and hubert's prefill step."""
    warm_vector_math()
    mesh, _ = make_mesh(shape, device="cpu")
    out = {case.name: decode_case(case, mesh, inits[case.name], tokens[case.name])
           for case in cases}
    if hubert is not None:
        cfg = get_smoke_config(HUBERT)
        out[HUBERT] = serve_mod.encode(cfg, params_from_jax(cfg, hubert, device="cpu"),
                                       hubert_frames(cfg), F32, "cpu", mesh).logits.numpy()
    return out


def run_cases(cases: list, reference: dict, with_hubert: bool = False) -> dict:
    """Each mesh's cases in one spawn of its ranks: by case name, the
    ranks' results."""
    runs = {}
    for shape in sorted({case.mesh for case in cases}):
        mine = [case for case in cases if case.mesh == shape]
        hubert = (sub(reference, f"{HUBERT}/init/")
                  if with_hubert and shape == HUBERT_MESH else None)
        ranks = run_local_ranks(
            mesh_rank, math.prod(shape),
            (shape, mine, {c.name: sub(reference, f"{c.name}/init/") for c in mine},
             {c.name: reference[f"{c.name}/tokens"] for c in mine}, hubert),
            timeout=RANK_TIMEOUT)
        for key in ranks[0]:
            runs[key] = [got[key] for got in ranks]
    return runs


@pytest.fixture(scope="module")
def port_runs(reference):
    return run_cases(CASES, reference, with_hubert=True)


def spec_paths(tree, prefix: str = ""):
    """``(key, spec)`` of a ``cache_specs`` tree, a spec (a tuple) a leaf."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from spec_paths(tree[k], f"{prefix}/{k}" if prefix else k)
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from spec_paths(v, f"{prefix}/{i}")
    else:
        yield prefix, tree


def reference_key(cfg, key: str) -> tuple[str, int | None]:
    """The reference's cache key of the port's ``layers/i/...`` and the
    layer's index on its stacked scan axis."""
    parts = key.split("/")
    loc, idx = _jax_location(cfg, int(parts[1]))
    return "/".join([loc, *parts[2:]]), idx


def whole_cache(case: Case, cfg, ranks: list) -> tuple[dict, list]:
    """Every cache leaf gathered whole from the ranks' parts (by
    ``cache_specs``), and the leaves where two ranks holding the same
    block differ."""
    sizes = dict(zip(AXES, case.mesh))
    meta = init_cache(cfg, case.batch, case.length, torch.float32, "meta")
    shapes = dict(leaf_paths(meta))
    out, differ = {}, []
    for key, spec in spec_paths(cache_specs(meta, sizes)):
        if not isinstance(shapes[key], torch.Tensor):
            continue
        whole = np.zeros(shapes[key].shape, np.float32)
        seen = {}
        for got in ranks:
            local = got["cache"][key]
            idx = [slice(None)] * whole.ndim
            if spec[0] is not None:
                idx[0] = batch_rows(sizes, got["coords"], case.batch)
            if len(spec) > 1 and spec[1] == "model":
                n = local.shape[1]
                idx[1] = slice(got["coords"]["model"] * n, (got["coords"]["model"] + 1) * n)
            block = tuple((i.start, i.stop) for i in idx)
            if block in seen and not np.array_equal(seen[block], local):
                differ.append(key)
            seen[block] = local
            whole[tuple(idx)] = local
        out[key] = whole
    return out, differ


def case_failures(case: Case, ranks: list, reference: dict, cache_rel: float = CACHE_REL
                  ) -> list[str]:
    """What of the port's run of ``case`` differs from the reference's:
    a rank's next token (but at a near tie), a cache leaf gathered whole
    beyond ``cache_rel`` of its largest value, a length, or ranks that
    hold one block in other bits."""
    cfg = port_config(case)
    sizes = dict(zip(AXES, case.mesh))
    want_tokens = reference[f"{case.name}/tokens"]
    bad = []
    for got in ranks:
        rows = batch_rows(sizes, got["coords"], case.batch)
        logits = got["logits"]
        top = np.sort(logits, axis=-1)[..., -2:]
        second = np.argsort(logits, axis=-1)[..., -2]
        for r, row in enumerate(range(case.batch)[rows]):
            for t in range(1 + STEPS):
                want, first = want_tokens[row, t], logits[r, t].argmax()
                tie = top[r, t, 1] - top[r, t, 0] <= TIE * np.abs(logits[r, t]).max()
                if first != want and not (tie and second[r, t] == want):
                    bad.append(f"rank {got['coords']}, row {row}, step {t}: token {first}, "
                               f"the reference's {want}")
    whole, differ = whole_cache(case, cfg, ranks)
    bad += [f"{key}: ranks holding one block differ" for key in differ]
    want_cache = sub(reference, f"{case.name}/cache/")
    for key, got in whole.items():
        jkey, idx = reference_key(cfg, key)
        want = want_cache[jkey] if idx is None else want_cache[jkey][idx]
        err = float(np.abs(got - want).max())
        if err > cache_rel * max(float(np.abs(want).max()), 1e-30):
            bad.append(f"cache {key}: max abs err {err:.3e}, largest {np.abs(want).max():.3e}")
    for got in ranks:
        for key, value in got["cache"].items():
            if key.endswith("/len"):
                jkey, idx = reference_key(cfg, key)
                want = want_cache[jkey] if idx is None else want_cache[jkey][idx]
                if value != int(want):
                    bad.append(f"{key}: {value}, the reference's {int(want)}")
    return bad


# ---------------------------------------------------------------------------
# the tests
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("max_len", SPEC_LENGTHS)
@pytest.mark.parametrize("shape", SPEC_MESHES, ids=mesh_key)
def test_cache_specs_are_the_references(shape, max_len, reference):
    """``cache_specs`` of every arch's full-size cache is
    ``_cache_shardings``' leaf by leaf (the stacked scan axis mapped
    away): the batch over the batch axes that divide it, the sequence over
    ``model`` from 8192 positions where ``model`` divides it, never a
    ring (recurrentgemma's 2048) nor a recurrent state."""
    sizes = dict(zip(AXES, shape))
    for arch in ARCHS:
        cfg = get_config(arch)
        for batch in SPEC_BATCHES:
            want = reference["specs"][f"{arch}/{mesh_key(shape)}/{max_len}/{batch}"]
            got = cache_specs(init_cache(cfg, batch, max_len, torch.float32, "meta"), sizes)
            seen = set()
            for key, spec in spec_paths(got):
                jkey, idx = reference_key(cfg, key)
                w = [tuple(e) for e in want[jkey]]
                if idx is not None and w:
                    w = w[1:]
                assert norm_spec(spec) == tuple(w), (arch, batch, key, spec, w)
                seen.add(jkey)
            assert seen == set(want), (arch, batch, sorted(set(want) - seen))
            split = {key for key, spec in spec_paths(got) if "model" in spec}
            long = max_len % shape[2] == 0 and max_len >= 8192 and shape[2] > 1
            assert bool(split) == (long and any(b.mixer in ("attn", "mla")
                                                for b in cfg.block_list())), (arch, split)


def test_a_split_recurrent_leaf_is_refused():
    """The rule would split a leaf of 8192 entries or more after its batch
    dim whatever it holds; the port merges only attention and MLA caches."""
    with pytest.raises(NotImplementedError, match="layers/0/tmix/shift"):
        cache_specs({"layers": [{"tmix": {"shift": torch.zeros(2, 8192, device="meta")}}]},
                    {"pod": 1, "data": 1, "model": 2})


def test_init_local_cache_has_the_specs_local_shapes():
    """A rank's cache: its rows and, on a split sequence, its half."""
    cfg = get_smoke_config("deepseek-v3-671b")
    sizes = {"pod": 1, "data": 2, "model": 2}
    for max_len, seq in ((64, 64), (8200, 4100)):
        local = init_local_cache(cfg, 4, max_len, sizes, torch.float32, "cpu")
        for layer in local["layers"]:
            assert layer["ckv"].shape == (2, seq, cfg.mla.kv_lora_rank)
            assert layer["kr"].shape == (2, seq, cfg.mla.qk_rope_head_dim)
            assert layer.get("seq_shards", 1) == (2 if seq < max_len else 1)


@pytest.mark.parametrize("case", CASES, ids=[c.name for c in CASES])
def test_mesh_decode_matches_the_references(case, reference, port_runs):
    """Each rank's rows' tokens, and the cache gathered whole, are the
    reference's after its prefill and ``STEPS`` decode steps on the mesh:
    heads split over ``model`` against a whole cache (every kv head on
    every rank), experts split over ``model`` (granite routes each
    ``data`` rank's rows, at 1.25 dropping some; on (1, 2, 1) the pod's
    rows together), the cross block over the image of every step, the ring
    wrapped, the recurrent state."""
    bad = case_failures(case, port_runs[case.name], reference)
    assert not bad, "\n".join(bad)


def test_hubert_prefill_step_on_a_mesh_matches_the_references(reference, port_runs):
    """``encode(mesh=)`` on (1, 2, 2): each ``data`` rank's rows, heads
    split over ``model``; every rank returns every row's logits."""
    want = reference[f"{HUBERT}/logits"]
    for got in port_runs[HUBERT]:
        err = float(np.abs(got - want).max())
        assert err <= CACHE_REL * float(np.abs(want).max()), err


def test_a_short_cache_moves_no_merge_bytes(port_runs):
    """A cache whole along the sequence takes no sequence merge."""
    for case in CASES:
        assert all(got["merge_bytes"] == 0 for got in port_runs[case.name]), case.name


if __name__ == "__main__" and sys.argv[1:2] == ["reference"]:
    reference_main(sys.argv[2])

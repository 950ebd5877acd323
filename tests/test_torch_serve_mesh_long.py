"""Serving on a mesh with a cache whose sequence is split over ``model``
(8200 positions: 4100 a ``model`` rank), against the reference's
``build_serve_step`` on the CPU, with the reference run and the checks of
``test_torch_serve_mesh.py``.

Cases (smoke configs, f32 compute on an f32 cache):

* minitron-8b on (1, 2, 2), 2 rows, a prompt of 4104 tokens prefilled in
  chunks of 1026: the first three chunks leave model rank 1's shard empty
  (it must add nothing), the fourth straddles the two shards (4100 is in
  it), and the decode steps write rank 1's positions;
* deepseek-v3-671b (MLA: each rank re-projects k and v from its own
  latents) on (1, 2, 2), the same prompt;
* minitron-8b on (2, 2, 2), 4 rows, a prompt of 9: rank 1's shard stays
  empty throughout.

Tolerances: tokens as ``test_torch_serve_mesh.py`` holds them (but at a
near tie); every cache leaf gathered whole within 1e-5 of its largest
value of the port's one process decoding over the whole cache (the same
weights, prompt chunks and tokens), which isolates the split, and within
``LONG_REL`` = 5e-5 of the reference's.  Not 1e-5 there: the reference's
jitted RoPE at positions past ~3000 rounds otherwise than its own eager
``apply_rope`` and the port's (5.6e-5 on keys of norm ~4 at positions
3591-4103, head dim 16; 4.8e-7 eager), so minitron's one-process keys
already differ by 1.5e-5 of their largest, with no mesh.  Mutations,
on the first case from its prefilled cache: model rank 1's shard of every
layer zeroed before each decode step, and a merge that drops the last
rank's part, must each fail those checks and move the decode's logits by
more than the tolerance.
"""

import sys

import numpy as np
import pytest
import torch

from repro_torch.models.convert import params_from_jax
from repro_torch.models.model import init_cache
from repro_torch.train.train_step import build_serve_step
from repro_torch.tree import leaf_paths
from test_torch_serve_mesh import (CACHE_REL, F32, MUTATIONS, STEPS, Case, case_failures,
                                   case_inputs, port_config, reference_decode, run_cases,
                                   run_reference, sub, whole_cache)

LONG = 8200
LONG_REL = 5e-5
CASES = [
    Case("minitron-8b on 1x2x2, a 4104-token prompt", "minitron-8b", (1, 2, 2), batch=2,
         prompt=4104, chunk=1026, max_len=LONG, mutations=True),
    Case("deepseek-v3-671b on 1x2x2, a 4104-token prompt", "deepseek-v3-671b", (1, 2, 2),
         batch=2, prompt=4104, chunk=1026, max_len=LONG),
    Case("minitron-8b on 2x2x2, rank 1 empty", "minitron-8b", (2, 2, 2), max_len=LONG),
]


def reference_main(out_dir: str) -> None:
    import os

    out = {}
    for case in CASES:
        out.update(reference_decode(case))
    np.savez(os.path.join(out_dir, "reference.npz"), **out)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    return run_reference(tmp_path_factory, __file__)


@pytest.fixture(scope="module")
def port_runs(reference):
    return run_cases(CASES, reference)


def one_process(case: Case, reference: dict) -> dict[str, np.ndarray]:
    """The port's cache after the case's prefill and decode in one process
    over the whole cache, fed the reference's tokens."""
    cfg = port_config(case)
    params = params_from_jax(cfg, sub(reference, f"{case.name}/init/"), device="cpu")
    prompts, _ = case_inputs(case, cfg)
    tokens = reference[f"{case.name}/tokens"]
    step = build_serve_step(cfg, F32, kind="decode", device="cpu")
    cache = init_cache(cfg, case.batch, case.length, torch.float32, "cpu")
    chunk = case.chunk or case.prompt
    for start in range(0, case.prompt, chunk):
        _, cache = step(params, cache, {"tokens": torch.from_numpy(prompts[:, start:start + chunk])})
    for t in range(STEPS):
        _, cache = step(params, cache, {"tokens": torch.from_numpy(tokens[:, t:t + 1])})
    return {k: v.numpy() for k, v in leaf_paths(cache) if isinstance(v, torch.Tensor)}


@pytest.mark.parametrize("case", CASES, ids=[c.name for c in CASES])
def test_split_cache_decode_matches_the_references(case, reference, port_runs):
    """The sequence split over ``model``: tokens and the whole cache are the
    reference's and one process', and the merge moved bytes."""
    ranks = port_runs[case.name]
    bad = case_failures(case, ranks, reference, LONG_REL)
    assert not bad, "\n".join(bad)
    whole, _ = whole_cache(case, port_config(case), ranks)
    for key, want in one_process(case, reference).items():
        err = float(np.abs(whole[key] - want).max())
        assert err <= CACHE_REL * float(np.abs(want).max()), (key, err)
    assert all(got["merge_bytes"] > 0 for got in ranks)
    assert {got["cache"]["layers/0/len"] for got in ranks} == {case.prompt + 4}


@pytest.mark.parametrize("mutation", MUTATIONS)
def test_a_broken_split_fails_the_checks(mutation, reference, port_runs):
    case = CASES[0]
    ranks = port_runs[case.name]
    assert case_failures(case, [dict(got, **got[mutation]) for got in ranks], reference,
                         LONG_REL)
    for got in ranks:
        want = got["logits"][:, 1:]
        err = float(np.abs(got[mutation]["logits"][:, 1:] - want).max())
        assert err > CACHE_REL * float(np.abs(want).max()), (mutation, err)


if __name__ == "__main__" and sys.argv[1:2] == ["reference"]:
    reference_main(sys.argv[2])

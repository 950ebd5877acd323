"""deepseek-v3-671b's training step on meshes that split ``data`` and
``model``, against the reference on the CPU: MLA runs whole on every rank
(the reference's MLA carries no head constraint, so GSPMD computes it
whole), its leaves summed over no ``model`` group; the MoE blocks split
their experts over ``model`` (expert parallelism) or, on (1, 2, 1), route
the pod's rows together (dense dispatch).

The reference runs in a child process with 8 forced host devices, its
meshes built with ``Auto`` axes (fault 1), and writes the loss and the
gradient of every leaf of ``loss_fn`` in f32 for deepseek-v3-671b's smoke
config (an MLA + dense block, then two MLA + MoE blocks with a shared
expert; capacity factor 8.0, which drops nothing at this size) under its
``distribution(mesh)`` on (1, 2, 1), (1, 1, 2) and (1, 2, 2), on one global
batch of 4 rows (each ``data`` rank's rows: ``SyncGrads.local`` refuses an
MoE on ``model`` > 1 whose rows do not split over ``data``).  The port runs
``SyncGrads.local`` on gloo ranks; what is compared and the tolerances are
``test_torch_cross_tp.py``'s (``check_step``): the loss within 1e-6, each
rank's gradient blocks within 1e-5 of each leaf's largest value.
"""

import sys

import pytest

from repro_torch.configs.registry import get_smoke_config
from repro_torch.models import model
from test_torch_cross_tp import check_step, mesh_key, reference_steps, run_reference

ARCH = "deepseek-v3-671b"
MESHES = [(1, 2, 1), (1, 1, 2), (1, 2, 2)]


def reference_main(out_dir: str) -> None:
    import os

    import numpy as np

    np.savez(os.path.join(out_dir, "reference.npz"), **reference_steps(ARCH, MESHES))


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    return run_reference(tmp_path_factory, __file__)


@pytest.mark.parametrize("shape", MESHES, ids=mesh_key)
def test_deepseek_v3_step_on_a_mesh_matches_the_reference(shape, reference):
    check_step(ARCH, shape, reference)


def test_mla_takes_no_region_leaf():
    """With ``model`` above 1 MLA computes whole on every rank, so none of
    its leaves is a part to sum over ``model``; the routed experts and the
    router are."""
    cfg = get_smoke_config(ARCH)
    keys = model.region_leaves(cfg)
    assert not any("/mixer/" in k for k in keys)
    assert {k.split("/")[1] for k in keys} == {
        str(i) for i, blk in enumerate(cfg.block_list()) if blk.ffn == "moe"}


if __name__ == "__main__" and sys.argv[1:2] == ["reference"]:
    reference_main(sys.argv[2])

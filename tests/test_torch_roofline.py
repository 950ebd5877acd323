"""The port's roofline (``repro_torch.launch.roofline``): ``model_flops``
against the reference's for every cell on both production meshes; the
terms of a record at the H100's spec peaks; the table over records that
the dry-run's CLI writes."""

import json
import subprocess
import sys
from pathlib import Path

import pytest

from repro.launch import roofline as ref_roofline
from repro_torch.configs import cells
from repro_torch.launch import roofline
from repro_torch.launch.mesh import production_mesh_shape

ROOT = Path(__file__).resolve().parents[1]
CELLS = [(a, s.name) for a, s in cells()]


@pytest.mark.parametrize("arch,shape", CELLS, ids=[f"{a}-{s}" for a, s in CELLS])
def test_model_flops_is_the_references(arch, shape):
    for multi in (False, True):
        mesh = dict(zip(("pod", "data", "model"), production_mesh_shape(multi)))
        ref_mesh = {k: v for k, v in mesh.items() if multi or k != "pod"}
        assert roofline.model_flops(arch, shape, mesh) == ref_roofline.model_flops(
            arch, shape, ref_mesh)


def _record(flops, nbytes, by_axes, dtype="bfloat16"):
    return {"arch": "minitron-8b", "shape": "train_4k", "mesh": "multi", "strategy": "hier",
            "mesh_shape": {"pod": 2, "data": 16, "model": 16}, "compute_dtype": dtype,
            "cost": {"flops": flops, "bytes": nbytes}, "collective_link_bytes_by_axes": by_axes,
            "memory": {"peak_gb": 1.0}, "trace_s": 0.0, "status": "ok"}


def test_terms_take_the_hopper_spec_peaks():
    assert roofline.PEAK_FLOPS == {"bfloat16": 989.4e12, "float32": 67e12}
    assert (roofline.HBM_BW, roofline.NVLINK_BW, roofline.POD_BW) == (3.35e12, 450e9, 50e9)
    t = roofline.roofline_terms(_record(989.4e12, 3.35e12 / 2, {"pod": 50e9 / 4,
                                                               "data+model": 450e9 / 4}))
    assert t["t_compute_s"] == pytest.approx(1.0) and t["t_memory_s"] == pytest.approx(0.5)
    assert t["t_collective_s"] == pytest.approx(0.5)
    assert (t["dominant"], t["roofline_step_s"]) == ("compute", pytest.approx(1.0))
    f32 = roofline.roofline_terms(_record(67e12, 0.0, {}, "float32"))
    assert f32["t_compute_s"] == pytest.approx(1.0)
    coll = roofline.roofline_terms(_record(0.0, 0.0, {"pod": 100e9}))
    assert (coll["dominant"], coll["t_collective_pod_s"]) == ("collective", pytest.approx(2.0))


def test_table_over_the_clis_records(tmp_path):
    env = {"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"}
    run = subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
                          "granite-moe-3b-a800m", "--shape", "decode_32k", "--tier", "reduced",
                          "--smoke", "--out", str(tmp_path / "dr")], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=600)
    assert run.returncode == 0, run.stdout + run.stderr
    (tmp_path / "dr" / "broken.json").write_text(json.dumps(
        {"arch": "x", "shape": "decode_32k", "mesh": "single", "strategy": "hier",
         "status": "fail", "error": "ValueError: no"}))
    table = subprocess.run([sys.executable, "-m", "repro_torch.launch.roofline", "--dryrun",
                            str(tmp_path / "dr"), "--out", str(tmp_path / "rl.json")],
                           cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300)
    assert table.returncode == 0, table.stdout + table.stderr
    rows = json.loads((tmp_path / "rl.json").read_text())
    ok = [r for r in rows if r["status"] == "ok"]
    assert sorted(r["mesh"] for r in ok) == ["multi", "single"]
    for r in ok:
        assert r["dominant"] in ("compute", "memory", "collective")
        assert r["roofline_step_s"] == max(r["t_compute_s"], r["t_memory_s"], r["t_collective_s"])
    assert "1 failed cells" in table.stdout and "granite-moe-3b-a800m" in table.stdout

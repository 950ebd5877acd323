"""The port's shape cells and active parameter counts against the
reference's: ``SHAPES``, ``ShapeSpec``, ``applicable_shapes``,
``ModelConfig.is_attention_free`` and ``supports_long_context``, the
registry's ``cells()`` (31 over the 10 configs) and
``models.model.active_param_count`` for every full config."""

import dataclasses

import pytest

from repro.configs import base as ref_base
from repro.configs import registry as ref_registry
from repro_torch.configs import SHAPES, ShapeSpec, applicable_shapes, cells, get_config
from repro_torch.configs.registry import ARCHS
from repro_torch.models.model import active_param_count, param_count


def test_shapes_are_the_references():
    assert [f.name for f in dataclasses.fields(ShapeSpec)] == [
        f.name for f in dataclasses.fields(ref_base.ShapeSpec)]
    assert {k: dataclasses.astuple(v) for k, v in SHAPES.items()} == {
        k: dataclasses.astuple(v) for k, v in ref_base.SHAPES.items()}


def test_cells_are_the_references():
    got = [(a, s.name) for a, s in cells(tuple(ref_registry.ARCHS))]
    assert got == [(a, s.name) for a, s in ref_registry.cells()]
    assert len(cells()) == 31
    assert sorted((a, s.name) for a, s in cells()) == sorted(got)


@pytest.mark.parametrize("arch", ARCHS)
def test_shape_skips_are_the_references(arch):
    cfg, ref = get_config(arch), ref_registry.get_config(arch)
    assert cfg.is_attention_free == ref.is_attention_free
    assert cfg.supports_long_context == ref.supports_long_context
    assert [s.name for s in applicable_shapes(cfg)] == [
        s.name for s in ref_base.applicable_shapes(ref)]


@pytest.mark.parametrize("arch", ARCHS)
def test_active_param_count_is_the_references(arch):
    from repro.models.model import active_param_count as ref_active

    cfg = get_config(arch)
    assert active_param_count(cfg) == ref_active(ref_registry.get_config(arch))
    if cfg.moe is None:
        assert active_param_count(cfg) == param_count(cfg)
    else:
        assert 0 < active_param_count(cfg) < param_count(cfg)

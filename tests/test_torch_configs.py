"""The port's configurations (``repro_torch.configs``) are the JAX
package's: the same ten ids, every ``CONFIG`` and ``SMOKE_CONFIG`` equal
field by field, the same derived sizes and the same shape registry."""

import dataclasses

import pytest

jconfigs = pytest.importorskip("repro.configs")
from repro_torch import configs  # noqa: E402


def test_ids_and_shapes_are_the_jax_packages():
    assert configs.ARCH_IDS == jconfigs.ARCH_IDS
    assert {k: dataclasses.asdict(v) for k, v in configs.SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in jconfigs.SHAPES.items()}


def test_arch_config_has_the_jax_fields():
    assert [(f.name, f.default) for f in dataclasses.fields(configs.ArchConfig)] \
        == [(f.name, f.default) for f in dataclasses.fields(jconfigs.ArchConfig)]


@pytest.mark.parametrize("smoke", [False, True], ids=["CONFIG", "SMOKE_CONFIG"])
@pytest.mark.parametrize("arch", jconfigs.ARCH_IDS)
def test_config_equals_the_jax_one_field_by_field(arch, smoke):
    mine = configs.get_config(arch, smoke=smoke)
    ref = jconfigs.get_config(arch, smoke=smoke)
    assert type(mine).__module__ == "repro_torch.configs.base"
    assert dataclasses.asdict(mine) == dataclasses.asdict(ref)
    assert (mine.head_dim_, mine.padded_vocab, mine.is_encdec,
            mine.supports_long_context, mine.param_count(),
            mine.active_param_count()) == \
        (ref.head_dim_, ref.padded_vocab, ref.is_encdec,
         ref.supports_long_context, ref.param_count(),
         ref.active_param_count())
    for shape in configs.SHAPES.values():
        assert configs.cell_is_skipped(mine, shape) == \
            jconfigs.cell_is_skipped(ref, jconfigs.SHAPES[shape.name])

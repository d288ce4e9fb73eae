"""The port's configs against the reference's: all ten ``ArchConfig``s,
full and smoke, field for field; their parameter counts; the shape
registry; and the cache / input specs (shapes and dtypes)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro_torch import configs
from repro_torch.configs import TensorSpec

ARCHS = configs.ARCH_NAMES


def _dtype(jdt):
    """The torch dtype of a jax/numpy dtype, by name."""
    return {"float32": torch.float32, "bfloat16": torch.bfloat16,
            "int32": torch.int32}[jnp.dtype(jdt).name]


def test_registry_names_equal():
    assert configs.ARCH_NAMES == jconfigs.ARCH_NAMES


@pytest.mark.parametrize("smoke", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
class TestConfig:
    def test_every_field_equal(self, arch, smoke):
        got = dataclasses.asdict(configs.get_config(arch, smoke=smoke))
        want = dataclasses.asdict(jconfigs.get_config(arch, smoke=smoke))
        assert got == want

    def test_derived_properties_and_counts(self, arch, smoke):
        got = configs.get_config(arch, smoke=smoke)
        want = jconfigs.get_config(arch, smoke=smoke)
        for name in ("attn_free", "d_inner", "ssm_n_heads", "sub_quadratic"):
            assert getattr(got, name) == getattr(want, name), name
        assert got.n_params() == want.n_params()
        assert got.n_active_params() == want.n_active_params()

    def test_cache_specs(self, arch, smoke):
        got = configs.cache_specs(configs.get_config(arch, smoke=smoke), 3,
                                  40)
        want = jconfigs.cache_specs(jconfigs.get_config(arch, smoke=smoke),
                                    3, 40)
        assert set(got) == set(want)
        for key, spec in got.items():
            assert isinstance(spec, TensorSpec)
            assert spec.shape == tuple(want[key].shape), key
            assert spec.dtype == _dtype(want[key].dtype), key

    def test_input_specs(self, arch, smoke):
        cfg = configs.get_config(arch, smoke=smoke)
        jcfg = jconfigs.get_config(arch, smoke=smoke)
        for shape in configs.SHAPES:
            ok, why = configs.shape_applicable(cfg, configs.SHAPES[shape])
            assert ok == jconfigs.shape_applicable(
                jcfg, jconfigs.SHAPES[shape])[0]
            assert ok == (why == "")
            if not ok:
                with pytest.raises(ValueError, match="skipped"):
                    configs.input_specs(cfg, shape)
                continue
            kind, got = configs.input_specs(cfg, shape)
            jkind, want = jconfigs.input_specs(jcfg, shape)
            assert kind == jkind
            flat_got = dict(_flat(got))
            flat_want = {k: (tuple(v.shape), _dtype(v.dtype))
                         for k, v in _flat(want)}
            assert {k: (v.shape, v.dtype) for k, v in flat_got.items()} \
                == flat_want


def _flat(specs, prefix=""):
    for k, v in specs.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + k + ".")
        else:
            yield prefix + k, v


def test_shapes_registry_equal():
    assert {k: dataclasses.astuple(v) for k, v in configs.SHAPES.items()} \
        == {k: dataclasses.astuple(v) for k, v in jconfigs.SHAPES.items()}


def test_published_sizes():
    """The two configs served at full depth on the card, by their counts."""
    assert configs.get_config("qwen3-1.7b").n_params() == 1_720_574_976
    assert configs.get_config("mamba2-130m").n_params() == 128_983_488


def test_unknown_arch_and_bad_configs_raise():
    with pytest.raises(KeyError, match="unknown arch"):
        configs.get_config("gpt-5")
    cfg = configs.get_config("qwen3-1.7b", smoke=True)
    with pytest.raises(ValueError, match="not a multiple"):
        cfg.replace(n_heads=5)
    with pytest.raises(ValueError, match="pattern covers"):
        configs.get_config("zamba2-1.2b", smoke=True).replace(n_layers=9)


def test_replace_and_d_head_default():
    cfg = configs.ArchConfig(name="t", family="dense", n_layers=1,
                             d_model=64, n_heads=4, n_kv_heads=2, d_ff=8,
                             vocab_size=16)
    assert cfg.d_head == 16
    assert cfg.replace(compute_dtype="float32").compute_dtype == "float32"
    assert np.dtype(cfg.param_dtype) == np.float32

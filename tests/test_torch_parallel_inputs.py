"""``models.registry.input_specs`` and the batch and cache rules against
the reference's, exactly: for every LM config and every SHAPES cell, the
inputs' keys, shapes and dtypes (meta tensors against
``ShapeDtypeStruct``s, caches included for the decode cells), and their
``batch_specs`` and ``cache_specs`` on the pod, multipod, tiny and
tinypod meshes under both strategies.
"""
import pytest

from parallel_parity import (NAMED, STRATEGIES, meshes, port_shapes,  # noqa
                             port_specs, ref_shapes, ref_specs, strategy)
from repro.configs import LM_ARCH_IDS
from repro.configs import get_config as j_config
from repro.models.registry import SHAPES as J_SHAPES
from repro.models.registry import input_specs as j_input_specs
from repro.parallel import sharding as j_shd
from repro_torch.configs import get_config
from repro_torch.models.registry import SHAPES, input_specs
from repro_torch.parallel import sharding as t_shd


def test_shapes_table():
    assert SHAPES == J_SHAPES


@pytest.mark.parametrize("arch_id", LM_ARCH_IDS)
def test_inputs_and_their_specs(arch_id, strategy):
    jcfg, cfg = j_config(arch_id), get_config(arch_id)
    for shape in SHAPES:
        jb, jc = j_input_specs(jcfg, shape)
        b, c = input_specs(cfg, shape)
        assert port_shapes(b) == ref_shapes(jb), (arch_id, shape)
        assert (c is None) == (jc is None)
        if c is not None:
            assert port_shapes(c) == ref_shapes(jc), (arch_id, shape)
        assert all(x.device.type == "meta" for x in b.values())
        for mode in STRATEGIES:
            strategy(mode)
            for name in NAMED:
                jm, tm = meshes(name)
                assert port_specs(b, t_shd.batch_specs(cfg, b, tm)) == \
                    ref_specs(j_shd.batch_specs(jcfg, jb, jm)), \
                    (arch_id, shape, mode, name)
                if c is not None:
                    assert port_specs(c, t_shd.cache_specs(cfg, c, tm)) == \
                        ref_specs(j_shd.cache_specs(jcfg, jc, jm)), \
                        (arch_id, shape, mode, name)

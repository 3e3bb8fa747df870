"""The port's sharding rules (``repro_torch.parallel.sharding``) against
the reference's, exactly, leaf by leaf: the param specs and the optimizer
state specs (AdamW, Adafactor, SGD with momentum) of all ten LM configs at
full size -- the port's ``init(device="meta")`` against the reference's
``jax.eval_shape`` -- on the pod, multipod, tiny and tinypod meshes, under
the "2d" and "dp" strategies.  Also ``train.step.state_specs`` against the
reference's, and the named meshes' shapes, batch axes and tensor-parallel
degree.
"""
import jax
import pytest

from parallel_parity import (NAMED, STRATEGIES, meshes, port_shapes,  # noqa
                             port_specs, ref_shapes, ref_specs, strategy)
from repro.configs import LM_ARCH_IDS
from repro.configs import get_config as j_config
from repro.models.registry import make_arch as j_arch
from repro.parallel import mesh as j_mesh
from repro.parallel import sharding as j_shd
from repro.train import optim as j_optim
from repro.train.step import state_specs as j_state_specs
from repro_torch.configs import get_config
from repro_torch.models.registry import make_arch
from repro_torch.parallel import mesh as t_mesh
from repro_torch.parallel import sharding as t_shd
from repro_torch.train import optim
from repro_torch.train.step import state_specs

OPTS = ("adamw", "adafactor", "sgdm")


def trees(arch_id):
    """{tree name: (reference shapes, port meta tree)}: the params and each
    optimizer's state."""
    ja = j_arch(j_config(arch_id))
    jp = jax.eval_shape(lambda: ja.init(jax.random.PRNGKey(0)))
    tp = make_arch(get_config(arch_id)).init(__import__("torch").Generator(),
                                             device="meta")
    out = {"params": (jp, tp)}
    for name in OPTS:
        jo = j_optim.OPTIMIZERS[name](j_optim.constant_lr(1e-3))
        to = optim.OPTIMIZERS[name](optim.constant_lr(1e-3))
        out[name] = (jax.eval_shape(lambda: jo.init(jp)), to.init(tp))
    return out


@pytest.mark.parametrize("mode", STRATEGIES)
@pytest.mark.parametrize("arch_id", LM_ARCH_IDS)
def test_param_and_state_specs(arch_id, mode, strategy):
    strategy(mode)
    for what, (jt, tt) in trees(arch_id).items():
        assert port_shapes(tt) == ref_shapes(jt), (arch_id, what)
        for name in NAMED:
            jm, tm = meshes(name)
            want = ref_specs(j_shd.infer_param_specs(jt, jm))
            got = port_specs(tt, t_shd.infer_param_specs(tt, tm))
            assert got == want, (arch_id, what, name, mode)


@pytest.mark.parametrize("mode", STRATEGIES)
def test_state_specs(mode, strategy):
    """``train.step.state_specs``: shapes and specs of the whole state."""
    strategy(mode)
    for arch_id in ("qwen1.5-0.5b", "zamba2-1.2b"):
        cfg = get_config(arch_id)
        for name in ("tiny", "pod"):
            jm, tm = meshes(name)
            opt = optim.adafactor(optim.constant_lr(1e-4))
            jo = j_optim.adafactor(j_optim.constant_lr(1e-4))
            jshapes, jspecs = j_state_specs(j_arch(j_config(arch_id)), jo, jm)
            shapes, specs = state_specs(make_arch(cfg), opt, tm)
            assert port_shapes(shapes) == ref_shapes(jshapes)
            assert port_specs(shapes, specs) == ref_specs(jspecs)


@pytest.mark.parametrize("name", sorted(NAMED))
def test_named_meshes(name, strategy):
    """Axis names and sizes, batch axes and the tensor-parallel degree of
    each named mesh under both strategies (the reference read on its
    shape-only mesh: the rules read nothing else)."""
    jm, tm = meshes(name)
    assert tm.axis_names == tuple(jm.axis_names)
    assert tm.shape == dict(jm.shape)
    assert t_mesh.mesh_size(tm) == jm.size
    for mode in STRATEGIES:
        strategy(mode)
        assert t_mesh.get_strategy() == j_mesh.get_strategy() == mode
        assert t_mesh.batch_axes(tm) == j_mesh.batch_axes(jm)
        assert t_mesh.tp_size(tm) == j_mesh.tp_size(jm)
        for axes in ("model", ("data",), t_mesh.batch_axes(tm)):
            assert t_mesh.axis_size(tm, axes) == j_mesh.axis_size(jm, axes)

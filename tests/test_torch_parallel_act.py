"""The activation hooks (``repro_torch.parallel.act_sharding``) against the
reference's: the layout each hook chooses, exactly, on the pod, multipod,
tiny and tinypod meshes under both strategies.

The reference's choice is read by recording the ``NamedSharding`` its
hooks hand ``jax.lax.with_sharding_constraint`` (monkeypatched to record
and return its input) over a shape-only ``AbstractMesh``; the port realises the layouts in its
tensor-parallel compute (``parallel.tp``), and exposes the choice through
``residual_spec``, ``heads_spec``, ``expert_spec``, ``ec_spec``,
``tokens_spec`` and ``layer_param_specs``.  ``gather_layer_params`` also
casts as the reference does (dtypes of every gathered leaf, run under
``jax.eval_shape``), and with no registry every hook is the identity.
"""
import jax
import numpy as np
import pytest
import torch

from parallel_parity import (NAMED, STRATEGIES, meshes, norm,  # noqa: F401
                             port_shapes, ref_shapes, spec_leaves, strategy)
from repro.configs import get_config as j_config
from repro.models.registry import make_arch as j_arch
from repro.parallel import act_sharding as j_act
from repro_torch.configs import get_config
from repro_torch.models.registry import make_arch
from repro_torch.parallel import act_sharding as t_act
from repro_torch.tree import flatten, unflatten

#: shapes each hook sees: batch sizes that divide the batch axes and
#: not, head / expert counts that divide 'model' and not, decode steps
HEADS = [(b, s, h, 64) for b in (1, 2, 6, 256) for s in (1, 4096)
         for h in (1, 12, 16, 64)]
EXPERTS = [(b, e, 5, 32) for b in (1, 2, 8, 256) for e in (3, 8, 64)]
FLAT3 = [(b, n, 32) for b in (1, 2, 8, 256) for n in (1, 15, 64, 4096)]
ROLES = ("residual", "residual_ssm", "residual_b1")


@pytest.fixture
def recorded(monkeypatch):
    """The specs the reference hands ``with_sharding_constraint``, in
    call order."""
    seen = []

    def wsc(x, sharding):
        seen.append(norm(sharding.spec))
        return x
    monkeypatch.setattr(jax.lax, "with_sharding_constraint", wsc)
    return seen


def ref_choice(fn, shape, seen, *args):
    """The spec the reference hook ``fn`` chose for ``shape`` (None: it
    left the tensor unconstrained)."""
    n = len(seen)
    fn(jax.ShapeDtypeStruct(shape, "float32"), *args)
    assert len(seen) - n in (0, 1)
    return seen[-1] if len(seen) > n else None


@pytest.mark.parametrize("mode", STRATEGIES)
@pytest.mark.parametrize("name", sorted(NAMED))
def test_activation_choices(name, mode, strategy, recorded):
    strategy(mode)
    jm, tm = meshes(name)
    j_act.set_mesh_shardings(jm)
    t_act.set_mesh_shardings(tm)
    for key in ("residual", "residual_b1", "residual_ssm"):
        assert norm(t_act._REGISTRY[key].spec) == \
            norm(j_act._REGISTRY[key].spec)
    for k in ("dp_size", "mp_size", "strategy"):
        assert t_act._REGISTRY[k] == j_act._REGISTRY[k]
    cases = [(j_act.constrain_heads, t_act.heads_spec, HEADS),
             (j_act.constrain_expert, t_act.expert_spec, EXPERTS),
             (j_act.constrain_ec, t_act.ec_spec, FLAT3),
             (j_act.constrain_tokens, t_act.tokens_spec, FLAT3 + HEADS)]
    for jfn, tfn, shapes in cases:
        for shape in shapes:
            assert norm(tfn(shape)) == ref_choice(jfn, shape, recorded), \
                (jfn.__name__, shape)
    for role in ROLES:
        for shape in FLAT3 + HEADS:
            assert norm(t_act.residual_spec(shape, role)) == ref_choice(
                j_act.constrain, shape, recorded, role), (role, shape)


def layer_trees(arch_id):
    """One layer's params of the full config (the first of each stack):
    reference ShapeDtypeStructs and port meta tensors."""
    ja = j_arch(j_config(arch_id))
    jp = jax.eval_shape(lambda: ja.init(jax.random.PRNGKey(0)))
    tp = make_arch(get_config(arch_id)).init(torch.Generator(),
                                             device="meta")
    root = "encoder" if "encoder" in tp else "layers"
    jl = jax.tree_util.tree_map(
        lambda x: jax.ShapeDtypeStruct(x.shape[1:], x.dtype), jp[root])
    return jl, unflatten(tp[root], [x[0] for x in flatten(tp[root])[1]])


@pytest.mark.parametrize("arch_id", ["qwen1.5-0.5b", "deepseek-moe-16b",
                                     "falcon-mamba-7b", "zamba2-1.2b",
                                     "seamless-m4t-large-v2"])
def test_layer_gather_choices(arch_id, strategy, recorded):
    jl, tl = layer_trees(arch_id)
    for mode in STRATEGIES:
        strategy(mode)
        for name in NAMED:
            jm, tm = meshes(name)
            j_act.set_mesh_shardings(jm)
            t_act.set_mesh_shardings(tm)
            recorded.clear()
            # a fresh function each time: eval_shape caches its trace
            out = jax.eval_shape(lambda t: j_act.gather_layer_params(t), jl)
            got = [norm(s) for s in spec_leaves(t_act.layer_param_specs(tl))]
            assert got == recorded, (arch_id, mode, name)
            assert port_shapes(t_act.gather_layer_params(tl)) == \
                ref_shapes(out), (arch_id, mode, name)


def test_hooks_are_identities(tmp_path):
    """With no registry every hook returns its input.  With one, outside a
    sharded step, the ``constrain*`` hooks still do (a layout never changes
    values) and ``gather_layer_params`` casts.  Inside ``zero3`` on a
    mesh whose ``model`` axis holds one rank nothing computes
    tensor-parallel: ``constrain`` keeps the whole residual, no leaf is a
    ``model`` block, and a train step's gather casts where the serving
    engine's does not.  (Two ranks: the residual is cut to the rank's
    sequence block -- ``tests/test_torch_lm_mesh_tp.py``.)"""
    import torch_mesh
    from repro_torch.core.distributed import P, make_mesh
    x4, x3 = torch.randn(2, 3, 4, 5), torch.randn(2, 4, 4)
    lp = {"attn": {"wq": torch.randn(4, 2, 2)}, "ln1": {"scale": x3[0, 0]}}
    t_act.clear()
    assert t_act.gather_layer_params(lp) is lp
    for fn, x in ((t_act.constrain_heads, x4), (t_act.constrain_expert, x4),
                  (t_act.constrain_ec, x3), (t_act.constrain_tokens, x3),
                  (t_act.constrain, x3)):
        assert fn(x) is x
    assert t_act.heads_spec(x4.shape) is None
    assert t_act.layer_param_specs(lp) is None
    assert t_act.model_axis() is None and not t_act.sharded()
    assert not t_act.sequence_parallel(x3.shape)
    try:
        t_act.set_mesh_shardings(meshes("tiny")[1])
        assert t_act.constrain(x3) is x3
        g = t_act.gather_layer_params(lp)
        assert g["attn"]["wq"].dtype == torch.bfloat16
        np.testing.assert_array_equal(
            g["attn"]["wq"].float().numpy(),
            lp["attn"]["wq"].to(torch.bfloat16).float().numpy())
        with torch_mesh.one_rank_group(tmp_path):
            mesh = make_mesh((1, 1), ("data", "model"), "cpu")
            specs = {"attn/wq": P(None, "model", None),
                     "ln1/scale": P(None)}
            for train in (True, False):
                with t_act.zero3(mesh, specs, (), train=train):
                    assert t_act.sharded() and t_act.model_axis() is None
                    assert not t_act.sequence_parallel(x3.shape)
                    assert t_act.constrain(x3) is x3
                    g = t_act.gather_layer_params(lp)
                    assert t_act.tp_dim(g["attn"]["wq"]) is None
                    np.testing.assert_array_equal(
                        g["attn"]["wq"].numpy(),
                        lp["attn"]["wq"].to(torch.bfloat16).float().numpy()
                        if train else lp["attn"]["wq"].numpy())
            assert not t_act.sharded()
    finally:
        t_act.clear()

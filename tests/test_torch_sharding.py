"""The port's sharding rules (``repro_torch.sharding``) against the
reference's ``repro.sharding.specs``, on the CPU.

Resolution is integer bookkeeping and must match exactly: every rule set
under every variant, at the production meshes' sizes (16 x 16 and 2 x 16
x 16, given as axis sizes: no devices are needed), over a grid of names
and shapes. The parameter specs of each family's reduced tree must equal
the reference's ``param_pspecs`` leaf by leaf (the dense family's
per-layer leaves without the stacked leaf's leading None), and their
DTensor placements must shard each tensor dim over the mesh axes that
spec names. ``lsc`` runs on a ``DTensor`` over a one-rank gloo mesh.
"""
import datetime
import itertools

import numpy as np
import pytest
import torch

from repro.sharding import specs as jsp
from repro_torch.sharding import specs as tsp

MESHES = {"16x16": {"data": 16, "model": 16},
          "2x16x16": {"pod": 2, "data": 16, "model": 16}}
RULE_SETS = ("TRAIN_RULES", "SERVE_RULES", "LONGCTX_RULES")
SIZES = (1, 2, 6, 8, 16, 24, 32, 48, 512)


def _names():
    keys = sorted(set(jsp.TRAIN_RULES) | set(jsp.SERVE_RULES))
    return [None, "unknown"] + keys


def _grid(seed):
    """One- to three-dim name tuples (every single name, every pair, a
    seeded sample of triples) with seeded shapes."""
    names = _names()
    g = np.random.default_rng(seed)
    tuples = [(n,) for n in names] + list(itertools.product(names, names))
    tuples += [tuple(g.choice(len(names), 3)) for _ in range(200)]
    tuples = [tuple(names[i] if isinstance(i, (int, np.integer)) else i
                    for i in t) for t in tuples]
    return [(t, tuple(int(g.choice(SIZES)) for _ in t)) for t in tuples]


def test_rule_sets_and_variants_are_the_reference_s():
    for name in RULE_SETS:
        assert getattr(tsp, name) == getattr(jsp, name), name
    assert tsp.VARIANTS == jsp.VARIANTS
    for v in (None, *jsp.VARIANTS, "seqpar,chunks_global"):
        assert tsp.apply_variant(tsp.TRAIN_RULES, v) == \
            jsp.apply_variant(jsp.TRAIN_RULES, v)


@pytest.mark.parametrize("rules", RULE_SETS)
@pytest.mark.parametrize("mesh", list(MESHES))
def test_resolve_matches_reference(rules, mesh):
    """Entry by entry, with and without the divisibility guard, for the
    rule set under no variant, each variant, and two together."""
    sizes = MESHES[mesh]
    axes = tuple(sizes)
    grid = _grid(len(rules) + len(mesh))
    for variant in (None, *jsp.VARIANTS, "weights_resident,fsdp2"):
        rj = jsp.apply_variant(getattr(jsp, rules), variant)
        rt = tsp.apply_variant(getattr(tsp, rules), variant)
        for names, shape in grid:
            want = tuple(jsp._resolve(rj, names, axes, shape, sizes))
            assert tsp._resolve(rt, names, axes, shape, sizes) == want, \
                (variant, names, shape)
            assert tsp._resolve(rt, names, axes) == \
                tuple(jsp._resolve(rj, names, axes)), (variant, names)


def test_resolve_guards():
    """The reference tests' cases: the divisibility guard, one use per
    axis, a missing pod axis, a tuple partly kept."""
    sizes = MESHES["16x16"]
    axes = tuple(sizes)
    r = {"kv_heads": "model", "batch": "data"}
    assert tsp._resolve(r, ("batch", "kv_heads"), axes, (128, 8),
                        sizes) == ("data", None)
    assert tsp._resolve(r, ("batch", "kv_heads"), axes, (128, 16),
                        sizes) == ("data", "model")
    assert tsp._resolve({"a": "model", "b": "model"}, ("a", "b"), axes,
                        (32, 32), sizes) == ("model", None)
    assert tsp._resolve({"batch": ("pod", "data")}, ("batch",), axes,
                        (32,), sizes) == ("data",)
    big = MESHES["2x16x16"]
    assert tsp._resolve({"batch": ("pod", "data")}, ("batch",), tuple(big),
                        (32,), big) == (("pod", "data"),)
    assert tsp._resolve({"batch": ("pod", "data")}, ("batch",), tuple(big),
                        (6,), big) == ("pod",)


ARCHS = ("tinyllama-1.1b", "granite-moe-1b-a400m", "mamba2-130m",
         "recurrentgemma-9b", "whisper-tiny")


def _reference_specs(arch, rules, sizes):
    """{reference path: spec} of the reference's reduced tree (shapes
    only), on a stand-in mesh of ``sizes`` (``param_pspecs`` reads its axis
    names and device grid's shape)."""
    import jax
    from types import SimpleNamespace
    from repro.configs import get_config
    from repro.models.model import build_model
    cfg = get_config(arch).reduced()
    tree = jax.eval_shape(build_model(cfg).init, jax.random.PRNGKey(0))
    mesh = SimpleNamespace(axis_names=tuple(sizes),
                           devices=np.empty(tuple(sizes.values())))
    specs = jsp.param_pspecs(tree, rules, mesh)
    flat = jax.tree_util.tree_flatten_with_path(
        specs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]
    return {tuple(str(getattr(k, "key", getattr(k, "idx", k)))
                  for k in path): tuple(s) for path, s in flat}


def _expected_placements(spec, sizes):
    from torch.distributed.tensor import Replicate, Shard
    out = []
    for ax in sizes:
        dims = [i for i, a in enumerate(spec)
                if a == ax or (isinstance(a, tuple) and ax in a)]
        out.append(Shard(dims[0]) if dims else Replicate())
    return tuple(out)


@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_match_reference(arch):
    """Leaf by leaf through ``reference_paths``, under both training and
    serving rules, at 16 x 16 and at a 4 x 2 mesh whose sizes the reduced
    widths do and do not divide."""
    from repro_torch.configs import get_config
    from repro_torch.convert import reference_paths
    from repro_torch.models.model import empty_params
    params = empty_params(get_config(arch).reduced())
    for rules, sizes in itertools.product(
            (jsp.TRAIN_RULES, jsp.SERVE_RULES),
            (MESHES["16x16"], {"data": 4, "model": 2},
             {"data": 3, "model": 1})):
        want = _reference_specs(arch, rules, sizes)
        got = tsp.param_specs(params, rules, sizes)
        pl = tsp.param_pspecs(params, rules, sizes)
        paths = list(reference_paths(params))
        assert {path for _, path, _ in paths} == set(want)
        for name, path, row in paths:
            ref = want[path]
            ref = ref[1:] if row is not None else ref
            assert got[name] == ref, (arch, name, sizes)
            assert pl[name] == _expected_placements(ref, sizes), name


def test_placements_refuse_an_order_dtensor_cannot_express():
    sizes = {"data": 4, "model": 2}
    with pytest.raises(ValueError, match="mesh order"):
        tsp.placements((("model", "data"),), sizes)
    # an axis of one device does not split: any order is the same split
    from torch.distributed.tensor import Shard
    assert tsp.placements((("model", "data"),), {"data": 4, "model": 1}) \
        == (Shard(0), Shard(0))


@pytest.fixture
def one_rank_mesh(tmp_path):
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/rdzv",
                            rank=0, world_size=1,
                            timeout=datetime.timedelta(seconds=60))
    try:
        yield init_device_mesh("cpu", (1,), mesh_dim_names=("data",))
    finally:
        dist.destroy_process_group()


def test_lsc_identity_without_rules():
    tsp.set_rules(None)
    x = torch.ones(4, 4)
    assert tsp.lsc(x, "batch", "d_model") is x
    with tsp.use_rules({"batch": "data"}):
        assert tsp.lsc(x, "batch", "d_model") is x     # a plain tensor
    assert tsp.current_rules() is None


def test_lsc_rank_alignment_on_a_dtensor(one_rank_mesh):
    """Names align from the right when rank differs (decode drops seq):
    three names on a rank-2 tensor put d_ff on its last dim."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    x = distribute_tensor(torch.arange(16.).view(2, 8), one_rank_mesh,
                          (Replicate(),))
    assert tsp.lsc(x, None, None, "d_ff") is x            # no rules
    with tsp.use_rules({"d_ff": "data"}):
        y = tsp.lsc(x, None, None, "d_ff")
        assert y.placements == (Shard(1),)
        assert y.shape == x.shape
        assert torch.equal(y.full_tensor(), x.full_tensor())
        z = tsp.lsc(y, "d_ff", None)
        assert z.placements == (Shard(0),)


def test_named_sharding_tree_distributes_values(one_rank_mesh):
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.configs import get_config
    from repro_torch.models.model import build_model
    mesh = init_device_mesh("cpu", (1, 1), mesh_dim_names=("data", "model"))
    cfg = get_config("tinyllama-1.1b").reduced()
    params = build_model(cfg).init(torch.Generator().manual_seed(0))
    tree = tsp.named_sharding_tree(params, tsp.TRAIN_RULES, mesh)
    pl = tsp.param_pspecs(params, tsp.TRAIN_RULES, mesh)
    for name, p in params.named_parameters():
        assert tree[name].placements == pl[name]
        assert torch.equal(tree[name].full_tensor(), p)

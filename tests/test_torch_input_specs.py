"""The dry run's arguments (``repro_torch.launch.input_specs``) against the
reference's: every leaf of every spec of every family, on both production
meshes, has on each rank the shape of the reference's
``NamedSharding.shard_shape`` of the same leaf. The reference builds its
specs in a subprocess on 512 forced CPU devices, nothing lowered or
compiled; the port builds its in torch's fake process group. Both cut the
stack to 2 layers (a stacked leaf's layer dim is never sharded: depth
changes no shard), the hybrid to one pattern cycle of 3 (the reference
cannot build it shorter). whisper-tiny at long_500k is skipped with the
reference's reason; every other spec of the three state families
builds."""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch
import torch.distributed as dist

from repro_torch.configs.base import INPUT_SHAPES

ROOT = Path(__file__).resolve().parents[1]
ARCHS = ("qwen1.5-0.5b", "tinyllama-1.1b", "llama3-8b",
         "mistral-large-123b", "internvl2-76b", "moska-llama3.1-8b",
         "granite-moe-1b-a400m", "arctic-480b", "mamba2-130m",
         "recurrentgemma-9b", "whisper-tiny")
STATE_ARCHS = ARCHS[-3:]
MESHES = {"16x16": False, "2x16x16": True}
LAYERS = 2
#: the depth each arch is cut to: the hybrid's one pattern cycle
DEPTH = dict.fromkeys(ARCHS, LAYERS) | {"recurrentgemma-9b": 3}

_REFERENCE = r"""
import dataclasses, json, sys
import jax
from repro.configs import get_config
from repro.launch import input_specs as ispecs
from repro.launch.mesh import make_production_mesh
depth = json.loads(sys.argv[3])
ispecs.get_config = lambda a: dataclasses.replace(get_config(a),
                                                  num_layers=depth[a])
archs, shapes = json.loads(sys.argv[1]), json.loads(sys.argv[2])
out = {}
for mp in (False, True):
    mesh = make_production_mesh(multi_pod=mp)
    name = "2x16x16" if mp else "16x16"
    for arch in archs:
        for shape in shapes:
            try:
                with mesh:
                    spec = ispecs.build(arch, shape, mesh)
            except ispecs.Skip:
                continue
            leaves = jax.tree_util.tree_flatten_with_path(spec.args)[0]
            rec = {}
            for path, leaf in leaves:
                key = "/".join(str(getattr(k, "key", getattr(
                    k, "idx", getattr(k, "name", None)))) for k in path)
                rec[key] = list(leaf.sharding.shard_shape(leaf.shape))
            out[f"{arch}|{shape}|{name}"] = rec
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def reference():
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=512",
               PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-c", _REFERENCE,
                          json.dumps(ARCHS), json.dumps(list(INPUT_SHAPES)),
                          json.dumps(DEPTH)], env=env, check=True,
                          timeout=600,
                         capture_output=True, text=True)
    return json.loads(res.stdout.strip().splitlines()[-1])


def _leaves(args):
    """{path: tensor} of a spec's arguments: parameters by name, the
    optimizer's moments, batch, cache and store fields."""
    from torch import nn
    from repro_torch.core.shared_kv import SharedKVStore
    from repro_torch.kvcache.cache import KVCache
    from repro_torch.training.optimizer import AdamWState
    out = {}

    def walk(prefix, x):
        if isinstance(x, nn.Module):
            for n, p in x.named_parameters():
                out[f"{prefix}{n}"] = p
        elif isinstance(x, AdamWState):
            walk(f"{prefix}mu.", x.mu)
            walk(f"{prefix}nu.", x.nu)
        elif isinstance(x, (KVCache, SharedKVStore)):
            for n, t in zip(x._fields, x):
                if t is not None:
                    out[f"{prefix}{n}"] = t
        elif isinstance(x, dict):
            for n, t in x.items():
                walk(f"{prefix}{n}.", t) if not isinstance(
                    t, torch.Tensor) else out.__setitem__(f"{prefix}{n}", t)
        elif isinstance(x, torch.Tensor):
            out[prefix.rstrip(".")] = x
    for i, a in enumerate(args):
        walk(f"{i}.", a)
    return out


def _per_layer(port_key: str) -> bool:
    """Whether a port leaf is one layer's row of the reference's stacked
    ``layers`` leaf (the dense family's layer modules)."""
    parts = port_key.split(".")
    return "layers" in parts and parts[parts.index("layers") + 1].isdigit()


def _ref_key(port_key: str) -> str:
    """A port leaf's path as the reference's: per-layer leaves are rows
    of the stacked ``layers`` leaf."""
    parts = port_key.split(".")
    if _per_layer(port_key):
        del parts[parts.index("layers") + 1]
    return "/".join(parts)


def _port_shapes(arch, shape, multi_pod):
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.launch import input_specs as ispecs
    from repro_torch.launch.mesh import init_fake_world, make_production_mesh
    init_fake_world(512 if multi_pod else 256)
    try:
        mesh = make_production_mesh(multi_pod=multi_pod, device="cpu")
        with FakeTensorMode(allow_non_fake_inputs=True):
            spec = ispecs.build(arch, shape, mesh, device="cpu",
                                layers=DEPTH[arch])
            return {k: (tuple(t.to_local().shape), tuple(t.shape))
                    for k, t in _leaves(spec.args).items()}
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_per_rank_shapes_equal_the_reference_shard_shapes(reference, arch,
                                                          mesh):
    for shape in INPUT_SHAPES:
        if arch == "whisper-tiny" and shape == "long_500k":
            assert f"{arch}|{shape}|{mesh}" not in reference     # skipped
            continue
        ref = reference[f"{arch}|{shape}|{mesh}"]
        got = _port_shapes(arch, shape, MESHES[mesh])
        assert len(got) > 10
        for key, (local, whole) in got.items():
            want = ref[_ref_key(key)]
            if _per_layer(key):
                want = want[1:]              # the stacked layer dim
            assert list(local) == want, (shape, key, local, whole, want)


def test_skips_name_their_reason():
    """whisper-tiny at long_500k keeps the reference's reason; every other
    spec of the state families builds at full depth (their 22 records)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.launch import input_specs as ispecs
    from repro_torch.launch.mesh import init_fake_world, make_production_mesh
    with pytest.raises(ispecs.Skip, match="no 500K-token decode analogue"):
        ispecs.build("whisper-tiny", "long_500k", None)
    assert not hasattr(ispecs, "NOT_YET")
    built = []
    for mp in (False, True):
        init_fake_world(512 if mp else 256)
        try:
            mesh = make_production_mesh(multi_pod=mp, device="cpu")
            with FakeTensorMode(allow_non_fake_inputs=True):
                for arch in STATE_ARCHS:
                    for shape in INPUT_SHAPES:
                        if (arch, shape) == ("whisper-tiny", "long_500k"):
                            continue
                        spec = ispecs.build(arch, shape, mesh, device="cpu")
                        assert len(_leaves(spec.args)) > 10
                        built.append((arch, shape, mp))
        finally:
            dist.destroy_process_group()
    assert len(built) == 22


def test_variants_change_the_placements():
    """``weights_resident`` keeps the weights whole over data, ``int8store``
    makes the store int8 with fp32 scales, ``expert_resident`` puts the
    experts over data and their d dim over model."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import Shard
    from repro_torch.launch import input_specs as ispecs
    from repro_torch.launch.mesh import init_fake_world, make_production_mesh
    init_fake_world(256)
    try:
        mesh = make_production_mesh(device="cpu")
        with FakeTensorMode(allow_non_fake_inputs=True):
            base = _leaves(ispecs.build(
                "tinyllama-1.1b", "decode_32k", mesh, layers=1).args)
            var = _leaves(ispecs.build(
                "tinyllama-1.1b", "decode_32k", mesh, layers=1,
                variant="weights_resident,int8store").args)
            moe = [_leaves(ispecs.build(
                "granite-moe-1b-a400m", "decode_32k", mesh, layers=1,
                variant=v).args) for v in (None, "expert_resident")]
    finally:
        dist.destroy_process_group()
    wq = "0.layers.0.attn.wq"
    assert base[wq].to_local().shape == (128, 128)
    assert var[wq].to_local().shape == (2048, 128)
    assert base["3.k"].dtype == torch.bfloat16 and "3.k_scale" not in base
    assert var["3.k"].dtype == torch.int8
    assert var["3.k_scale"].dtype == torch.float32
    e_gate = "0.layers.0.moe.e_gate"          # (32, 1024, 512)
    assert moe[0][e_gate].placements == (Shard(1), Shard(0))
    assert moe[1][e_gate].placements == (Shard(0), Shard(1))
    assert moe[1][e_gate].to_local().shape == (2, 64, 512)

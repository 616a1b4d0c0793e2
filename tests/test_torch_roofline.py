"""The port's roofline (``repro_torch.launch.roofline``) against the
reference's: the model-FLOP estimate of every architecture at every
assigned shape, and the derived terms of a record over the port's card
(an H100: bf16 tensor peak, HBM rate, the inter-node rate per card)."""
import dataclasses

import pytest

from repro.configs import get_config as jget_config
from repro.configs.base import INPUT_SHAPES as JSHAPES
from repro.launch import roofline as jrl
from repro_torch.configs import get_config, list_archs
from repro_torch.configs.base import INPUT_SHAPES
from repro_torch.launch import roofline as rl
from repro_torch.launch.mesh import HW
from repro_torch.launch.op_cost import Cost

ARCHS = list_archs()


def test_every_arch_and_shape_is_covered():
    assert len(ARCHS) == 11 and len(INPUT_SHAPES) == 4
    assert set(INPUT_SHAPES) == set(JSHAPES)


@pytest.mark.parametrize("shape", sorted(INPUT_SHAPES))
@pytest.mark.parametrize("arch", ARCHS)
def test_model_flops_estimate_equals_the_reference(arch, shape):
    want = jrl.model_flops_estimate(jget_config(arch), JSHAPES[shape])
    got = rl.model_flops_estimate(get_config(arch), INPUT_SHAPES[shape])
    assert got == want and got > 0


def test_terms_over_the_card():
    cost = Cost(flops=3.0e13, traffic=6.7e10, collective=2.0e9,
                per_collective={"all-reduce": 1.5e9, "all-gather": 5.0e8})
    r = rl.analyze(cost, 40e9, arch="tinyllama-1.1b", shape="train_4k",
                   mesh_name="16x16", chips=256,
                   cfg=get_config("tinyllama-1.1b"),
                   ishape=INPUT_SHAPES["train_4k"], note="n")
    assert r.compute_s == 3.0e13 / HW["peak_flops_bf16"]
    assert r.memory_s == 6.7e10 / HW["hbm_bw"]
    assert r.collective_s == 2.0e9 / HW["internode_bw"] == 0.04
    assert r.dominant == "collective"
    assert r.collectives == {"all-reduce": 1500000000,
                             "all-gather": 500000000}
    assert r.useful_flops_ratio == pytest.approx(
        r.model_flops / (3.0e13 * 256))
    assert "NVLink alone" in r.note and r.note.startswith("n; ")
    d = r.to_dict()
    # the reference's record keys, every field and derived term
    ref = jrl.Roofline("a", "s", "m", 1, 1.0, 1.0, 1.0, 1.0)
    assert set(d) == set(ref.to_dict())
    table = rl.format_table([r])
    assert "tinyllama-1.1b" in table and "collective" in table


def test_the_card_not_the_tpu():
    assert HW["name"].startswith("h100")
    assert HW["peak_flops_bf16"] == 989e12 and HW["hbm_bw"] == 3.35e12
    assert HW["internode_bw"] == 50e9

"""The plain reference against the port's CPU path, bitwise."""
import numpy as np
import pytest
import torch

from portbench import spec, system, weights
from portbench.reference import ops


@pytest.mark.parametrize("config,entry", [("fusionnet", "jit"),
                                          ("fusionnet", "jit_packed"),
                                          ("vggfusion", "jit"),
                                          ("vggfusion", "jit_packed")])
def test_reference_equals_the_port_bitwise_at_full_width(config, entry):
    """The configuration as the cells run it (published widths), one
    image, through the compiled callable's CPU path."""
    bench = spec.load()
    cfg = spec.config(bench, config)
    ref = spec.reference(cfg)
    gen = weights.generator(2 ** 31 + 17, "cpu")
    params = weights.draw(ref.layers(cfg), gen, "cpu")
    x = weights.images(gen, (1, cfg["hw"], cfg["hw"], cfg["in_ch"]), "cpu")
    got = system.build(cfg, dict(batch=1, entry=entry), params, "cpu")(x)
    want = ref.forward(params, x)
    assert got.dtype == want.dtype == torch.float32
    assert np.array_equal(got.numpy().view(np.uint32),
                          want.numpy().view(np.uint32))


def test_int4_control_changes_every_logit_row():
    bench = spec.load()
    cfg = spec.config(bench, "vggfusion")
    ref = spec.reference(cfg)
    gen = weights.generator(5, "cpu")
    params = weights.draw(ref.layers(cfg), gen, "cpu")
    x = weights.images(gen, (2, cfg["hw"], cfg["hw"], cfg["in_ch"]), "cpu")
    a = ref.forward(params, x)
    b = ref.forward(weights.int4_control(params), x)
    assert (a != b).any(dim=1).all()


def test_conv_acc_refuses_sums_float32_cannot_hold():
    x = torch.zeros(1, 3, 3, 2048)
    w = np.full((1, 2048, 3, 3), 127, np.int8)
    with pytest.raises(ValueError, match="not exact"):
        ops.conv_acc(x, w)


def test_weights_are_the_seeds_alone():
    bench = spec.load()
    cfg = spec.config(bench, "fusionnet")
    layers = spec.reference(cfg).layers(cfg)
    a = weights.draw(layers, weights.generator(2 ** 31 + 3, "cpu"), "cpu")
    b = weights.draw(layers, weights.generator(2 ** 31 + 3, "cpu"), "cpu")
    c = weights.draw(layers, weights.generator(2 ** 31 + 4, "cpu"), "cpu")
    assert all(np.array_equal(a[k][f], b[k][f]) for k in a
               for f in ("wei", "bia", "conv0_scales"))
    assert not np.array_equal(a["block1"]["wei"], c["block1"]["wei"])
    assert a["block1"]["wei1"].shape == (128, 128, 1, 1)
    assert a["head"]["dst_dt"] == "f32" and not a["head"]["conv0_relu"]

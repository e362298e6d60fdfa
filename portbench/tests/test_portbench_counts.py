"""The work and bounds of the configurations from their layer shapes."""
import pytest

from portbench import counts, spec

H100 = counts.PEAKS["NVIDIA H100 80GB HBM3"]


def layers(name):
    bench = spec.load()
    cfg = spec.config(bench, name)
    return {l["name"]: l for l in spec.reference(cfg).layers(cfg)}


def test_macs_per_image():
    f, v = layers("fusionnet"), layers("vggfusion")
    assert counts.model_macs(f.values()) == 1_374_437_376
    assert counts.model_macs(v.values()) == 520_257_536
    assert [counts.macs(f[k]) for k in
            ("stem", "block1", "branch", "res", "block2", "head")] == [
        115_605_504, 513_802_240, 51_380_224, 205_520_896, 488_112_128,
        16_384]
    assert counts.macs(v["block1_conv1"]) + counts.macs(
        v["block1_conv2"]) == 173_408_256


def test_bounds_match_the_kernel_table_rule():
    """PERF.md's kernel table at batch 8: FusionNet's fused blocks 0.0081
    ms, bound by operations; its stem, branch and res convs 0.0070 ms,
    bound by bytes."""
    f = layers("fusionnet")
    fused = [counts.bound_s(f[k], 8, H100) for k in ("block1", "block2")]
    assert {why for _, why in fused} == {"operations"}
    assert sum(s for s, _ in fused) * 1e3 == pytest.approx(0.0081, abs=5e-5)
    thin = [counts.bound_s(f[k], 8, H100) for k in ("stem", "branch", "res")]
    assert {why for _, why in thin} == {"bytes"}
    assert sum(s for s, _ in thin) * 1e3 == pytest.approx(0.0070, abs=5e-5)


def test_one_layer_bound_by_hand():
    """FusionNet's res conv at batch 256: 256x56x56x256 u8 in and out,
    256x256 int8 weights with 8 bytes of bias and scale a channel."""
    res = layers("fusionnet")["res"]
    moved = 2 * 256 * 56 * 56 * 256 + 256 * 256 + 8 * 256
    assert counts.layer_bytes(res, 256) == moved
    assert counts.bound_s(res, 256, H100) == (moved / 3.35e12, "bytes")


def test_a_pooled_layer_writes_its_pooled_output():
    v = layers("vggfusion")["block1_conv2"]
    assert counts.layer_bytes(v, 1) == (56 * 56 * 64 + 64 * 64 * 9 + 8 * 64
                                        + 28 * 28 * 64)

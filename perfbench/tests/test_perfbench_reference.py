"""The plain references against the port at small sizes: ResNet-50 at
``resnet50_spec(scale=16)`` and the qwen2 smoke config's decode step, on
the CPU; in float32 the two agree to rounding, in the served bfloat16 the
port stays within its precision; the float8 control does not."""
import pytest
import torch

from perfbench.harness import deploy as dp
from perfbench.reference import qwen2 as ref_qwen2
from perfbench.reference import resnet50 as ref_resnet
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.models.registry import get_bundle
from repro_torch.models.resnet import (port_layout, resnet50_forward,
                                       resnet50_spec)
from repro_torch.utils import tree_map


def _resnet_weights(scale, classes, seed=0):
    spec = resnet50_spec(num_classes=classes, scale=scale)

    def recipe(path, s):
        if path[-1] == "scale":
            return 0.1, 1.0
        if path[-1] == "bias":
            return 0.1, 0.0
        fan = 1
        for d in s.shape[:-1]:
            fan *= d
        return fan ** -0.5, 0.0
    return dp.draw_tree(spec, recipe, seed, "cpu", 1)


def _rel(a, b):
    return float((a - b).abs().max() / b.abs().max())


@pytest.mark.parametrize("img", [32, 33])
def test_resnet_reference_matches_port_f32(img):
    w = tree_map(lambda t: t.float(), _resnet_weights(16, 10))
    x = torch.randn(3, img, img, 3, generator=torch.Generator().manual_seed(1))
    got = resnet50_forward(port_layout(w), x.permute(0, 3, 1, 2))
    want = ref_resnet.forward(w, x)
    assert got.shape == want.shape == (3, 10)
    assert _rel(got, want) < 1e-5


def test_resnet_bf16_port_within_precision_and_control_outside():
    w = _resnet_weights(16, 10)
    x = torch.randn(4, 32, 32, 3, generator=torch.Generator().manual_seed(2))
    want = ref_resnet.forward(w, x)
    got = resnet50_forward(port_layout(w), x.permute(0, 3, 1, 2)).float()
    ctrl = ref_resnet.forward(w, x, "fp8")
    assert _rel(got, want) < 0.05
    assert _rel(ctrl, want) > 2 * _rel(got, want)


def _qwen2(cfg_dtype=torch.float32, seed=0):
    cfg = get_smoke_config("qwen2-0.5b")
    bundle = get_bundle(cfg)
    p = bundle.init(torch.Generator().manual_seed(seed))
    g = torch.Generator().manual_seed(seed + 1)
    p = tree_map(lambda t: (t.float() + 0.3 * torch.randn(
        t.shape, generator=g)).to(cfg_dtype), p)
    sizes = {"rms_norm_eps": cfg.norm_eps, "rope_theta": cfg.rope_theta,
             "vocab_size": cfg.vocab_size}
    return cfg, bundle, p, sizes


@pytest.mark.parametrize("cur", [0, 5, 16])
def test_qwen2_reference_matches_port_decode_f32(cur):
    cfg, bundle, p, sizes = _qwen2()
    tokens = torch.randint(0, cfg.vocab_size, (3, 1),
                           generator=torch.Generator().manual_seed(3))
    cache = bundle.init_cache(3, 32, dtype=torch.float32, device="cpu")
    got, _ = bundle.decode(p, cache, tokens, cur)
    want = ref_qwen2.decode_logits(p, sizes, tokens[:, 0], cur)
    assert got.shape[-1] == cfg.vocab_padded
    assert _rel(got[:, 0, :cfg.vocab_size], want) < 1e-5


def test_qwen2_bf16_port_within_precision_and_control_outside():
    cfg, bundle, p, sizes = _qwen2(torch.bfloat16)
    tokens = torch.randint(0, cfg.vocab_size, (4, 1),
                           generator=torch.Generator().manual_seed(4))
    cache = bundle.init_cache(4, 32, device="cpu")
    got, _ = bundle.decode(p, cache, tokens, 16)
    want = ref_qwen2.decode_logits(p, sizes, tokens[:, 0], 16)
    ctrl = ref_qwen2.decode_logits(p, sizes, tokens[:, 0], 16, "fp8")
    got = got[:, 0, :cfg.vocab_size].float()
    assert _rel(got, want) < 0.05
    assert _rel(ctrl, want) > 2 * _rel(got, want)


def test_qwen2_configuration_file_is_the_served_config():
    import json
    from pathlib import Path
    sizes = json.loads((Path(__file__).resolve().parents[1] / "configs"
                        / "qwen2-0.5b.json").read_text())
    cfg = get_config("qwen2-0.5b")
    assert (sizes["hidden_size"], sizes["intermediate_size"],
            sizes["num_attention_heads"], sizes["num_key_value_heads"],
            sizes["head_dim"], sizes["num_hidden_layers"],
            sizes["vocab_size"], sizes["rope_theta"],
            sizes["rms_norm_eps"]) == (
        cfg.d_model, cfg.d_ff, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim,
        cfg.num_layers, cfg.vocab_size, cfg.rope_theta, cfg.norm_eps)


@pytest.mark.gpu
def test_full_width_resnet_on_the_card_against_the_reference():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    w = _resnet_weights(1, 1000)
    w = tree_map(lambda t: t.cuda(), w)
    x = torch.randn(2, 224, 224, 3, device="cuda")
    with torch.inference_mode():
        got = resnet50_forward(port_layout(w), x.permute(0, 3, 1, 2))
    want = ref_resnet.forward(w, x)
    assert _rel(got.float(), want) < 0.05

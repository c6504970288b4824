"""Port parity for ResNet-50 (``repro_torch.models.resnet`` and
``serving.engine.make_resnet_model``) against the JAX package on the CPU.
Inputs are made from a seed with numpy; weights are the reference's,
bridged bit-exact through ``resnet.from_reference``.

Tolerances:

* one conv, ``allclose`` with rtol = atol = tol: f32 2e-4, bf16 2e-2 (the
  reference's kernel tolerances; the frameworks sum the products in another
  order and, in bf16, may round the f32 sum to a neighbouring bf16 value).
* max-pool: exact (a max rounds nothing).
* the whole forward, max |got - ref| <= tol * max(max |ref|, 1): f32 2e-4;
  bf16 2e-2 plus twice the reference's own bf16-vs-f32 error on the same
  weights and input. Over 53 convs, each rounded to bf16 with its BN and
  residual adds, the frameworks' rounding differences compound the way the
  reference's own bf16 result drifts from its f32 one (``ROADMAP.md`` §3).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import params as jp
from repro.models import resnet as jr
from repro.serving.engine import make_resnet_model as jax_make_resnet_model
from repro_torch.models import resnet as tr
from repro_torch.models.params import from_numpy_tree, param_bytes
from repro_torch.serving.engine import make_resnet_model
from repro_torch.utils import tree_leaves

TOL = {"float32": 2e-4, "bfloat16": 2e-2}
DTYPES = ["float32", "bfloat16"]
SIZES = [7, 8, 15, 16]


def _nchw(a):
    """An NHWC numpy array (f32 or bf16) as the port's NCHW channels_last
    tensor, bit for bit."""
    return from_numpy_tree(np.asarray(a), "cpu").permute(0, 3, 1, 2)


def _nhwc(t):
    return t.permute(0, 2, 3, 1).float().numpy()


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("k", [1, 3, 7])
def test_conv_matches_xla_same(k, stride, n, dtype):
    """XLA's "SAME" pads stride-2 convs at the end (a 3x3/2 on an even size
    pads (0, 1)); the port's conv must put the window where XLA does."""
    rng = np.random.default_rng(100 * k + 10 * stride + n)
    cin, cout = 5, 6
    x = jnp.asarray(rng.standard_normal((2, n, n + 1, cin)), dtype)
    w = jnp.asarray(rng.standard_normal((k, k, cin, cout)) / k, dtype)
    want = jax.lax.conv_general_dilated(
        x, w, (stride, stride), "SAME",
        dimension_numbers=("NHWC", "HWIO", "NHWC"))
    got = tr._conv(_nchw(x), tr.from_reference(np.asarray(w), "cpu"), stride)
    assert got.is_contiguous(memory_format=torch.channels_last)
    np.testing.assert_allclose(_nhwc(got), np.asarray(want, np.float32),
                               rtol=TOL[dtype], atol=TOL[dtype])


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n", SIZES)
def test_max_pool_pads_with_minus_inf(n, dtype):
    """All inputs negative: a zero-padded pool would return 0 at the
    borders, the reference's -inf padding never does."""
    rng = np.random.default_rng(n)
    x = jnp.asarray(-1.0 - np.abs(rng.standard_normal((2, n, n + 1, 4))),
                    dtype)
    want = jax.lax.reduce_window(x, -jnp.inf, jax.lax.max, (1, 3, 3, 1),
                                 (1, 2, 2, 1), "SAME")
    got = tr._max_pool(_nchw(x))
    assert (_nhwc(got) < 0).all()
    np.testing.assert_array_equal(_nhwc(got), np.asarray(want, np.float32))


def _ref_params(scale, seed=0):
    """The reference's bf16 ResNet-50 weights as numpy, with BN scale and
    bias drawn at random (the init's ones and zeros would leave BN
    untested)."""
    spec = jr.resnet50_spec(num_classes=256, scale=scale)
    params = jax.tree.map(np.asarray,
                          jp.materialize(spec, jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed)

    def bn(tree):
        if isinstance(tree, dict):
            if set(tree) == {"scale", "bias"}:
                c = tree["scale"].shape
                return {"scale": (1 + 0.2 * rng.standard_normal(c)).astype(
                            tree["scale"].dtype),
                        "bias": (0.2 * rng.standard_normal(c)).astype(
                            tree["bias"].dtype)}
            return {k: bn(v) for k, v in tree.items()}
        if isinstance(tree, tuple):
            return tuple(bn(v) for v in tree)
        return tree

    return bn(params)


def _to_hwio_bits(t):
    """A port-layout leaf back in the reference's layout, as raw bf16 bits."""
    if t.dim() == 4:
        t = t.permute(2, 3, 1, 0)
    elif t.dim() == 3:
        t = t[:, 0, 0]
    return t.contiguous().view(torch.int16).numpy()


def _pairs(ref, port, path="params"):
    """(path, reference leaf, port leaf), walking both trees by key."""
    if isinstance(ref, dict):
        assert set(ref) == set(port), path
        return [x for k in ref for x in _pairs(ref[k], port[k], f"{path}.{k}")]
    if isinstance(ref, tuple):
        assert len(ref) == len(port), path
        return [x for i, (r, p) in enumerate(zip(ref, port))
                for x in _pairs(r, p, f"{path}[{i}]")]
    return [(path, ref, port)]


def test_bridge_is_bit_exact_on_bf16():
    ref = _ref_params(scale=16)
    pairs = _pairs(ref, tr.from_reference(ref, "cpu"))
    # stem + BN, 16 blocks of 3 convs + 3 BNs, 4 projections + BN, head
    assert len(pairs) == 3 + 16 * 9 + 4 * 3 + 1
    for path, r, p in pairs:
        assert p.dtype == torch.bfloat16, path
        if p.dim() == 4:
            assert p.is_contiguous(memory_format=torch.channels_last), path
        np.testing.assert_array_equal(_to_hwio_bits(p), r.view(np.int16),
                                      err_msg=path)


def _forward_both(ref_params, x, dtype):
    """(port logits, reference logits, reference f32 logits) on the same
    weights cast to ``dtype`` and the same NHWC input."""
    cast = lambda a: np.asarray(jnp.asarray(a, dtype))          # noqa: E731
    jparams = jax.tree.map(cast, ref_params)
    want = jr.resnet50_forward(jparams, jnp.asarray(x))
    want32 = jr.resnet50_forward(
        jax.tree.map(lambda a: np.asarray(a, np.float32), ref_params),
        jnp.asarray(x))
    with torch.inference_mode():
        got = tr.resnet50_forward(tr.from_reference(jparams, "cpu"),
                                  _nchw(x))
    return got, np.asarray(want, np.float32), np.asarray(want32, np.float32)


def _assert_logits_close(got, want, want32, dtype):
    assert got.shape == want.shape and np.isfinite(want).all()
    err = float(np.abs(got.float().numpy() - want).max())
    bound = TOL[dtype] * max(float(np.abs(want).max()), 1.0)
    if dtype == "bfloat16":
        bound += 2 * float(np.abs(want - want32).max())
    assert err <= bound, (err, bound)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("img", [32, 33])
def test_forward_matches_reference(img, dtype):
    ref = _ref_params(scale=16, seed=img)
    x = np.random.default_rng(img).standard_normal(
        (2, img, img, 3)).astype(np.float32)
    got, want, want32 = _forward_both(ref, x, dtype)
    assert got.dtype == getattr(torch, dtype)
    _assert_logits_close(got, want, want32, dtype)


def test_make_resnet_model_inputs_are_the_references_draws():
    ref = jax_make_resnet_model("r", scale=16, img=32, seed=3)
    port = make_resnet_model("r", scale=16, img=32, seed=3, device="cpu")
    for b in (1, 2, 4, 1, 16):
        got = port.make_input(b)
        assert got.shape == (b, 3, 32, 32) and got.dtype == torch.float32
        assert got.is_contiguous(memory_format=torch.channels_last)
        np.testing.assert_array_equal(_nhwc(got), np.asarray(ref.make_input(b)))


@pytest.mark.parametrize("scale", [16, 1])
def test_make_resnet_model_weights_bytes(scale):
    want = jp.param_bytes(jr.resnet50_spec(num_classes=256, scale=scale))
    if scale == 1:
        assert want == 48_064_640           # 24,032,320 bf16 parameters
    assert param_bytes(tr.resnet50_spec(num_classes=256, scale=scale)) == want
    tm = make_resnet_model("r", scale=scale, img=32, batches=(1,),
                           device="cpu")
    assert tm.weights_bytes == want
    assert sum(t.nelement() * t.element_size()
               for t in tree_leaves(tm.host_params)) == want


def test_make_resnet_model_serves_the_references_forward():
    """The engine's forward, on the reference engine's weights bridged in,
    on the engine's own input draws, against ``resnet50_forward``."""
    ref = jax_make_resnet_model("r", scale=16, img=32, batches=(1, 2), seed=5)
    tm = make_resnet_model("r", scale=16, img=32, batches=(1, 2), seed=5,
                           device="cpu")
    tm.host_params = tr.from_reference(ref.host_params, "cpu")
    tm.load()
    x_ref = np.asarray(ref.make_input(2))
    with torch.inference_mode():
        got = tm.forward(tm.device_params, tm.make_input(2))
    want = np.asarray(jr.resnet50_forward(ref.host_params, x_ref), np.float32)
    want32 = np.asarray(jr.resnet50_forward(
        jax.tree.map(lambda a: np.asarray(a, np.float32), ref.host_params),
        x_ref))
    _assert_logits_close(got, want, want32, "bfloat16")
    assert tm.run(2) > 0


def test_make_resnet_model_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="cuda"):
        make_resnet_model("r")

"""One train step of each dense and MoE family (qwen2, gemma2, phi4-mini,
starcoder2, qwen3-moe, llama4-maverick) through the port's make_train_step
against the JAX package's, at smoke size in f32 on the reference's weights
(bridged bit for bit), with the config's optimizer. The mixer families
(Mamba2, RG-LRU, encoder-decoder, VLM) are in test_torch_train_mixers.py.

Both steps run an optimizer that also hands back, in its state, the
clipped gradients it was given (``with_grads``), so every leaf's gradient
is held to the reference's, not only the loss and the global norm.

Bounds, f32 (the same functions in another summation order): loss within
1e-5 relative, grad_norm within 1e-4 relative. Each leaf's gradient within
3e-4 of the leaf's largest element (the f32 bound of the reference's
test_flash_xla_custom_vjp_grads) plus 1e-6 of the model's largest gradient
element: the rounding noise of a leaf whose gradient is zero analytically
(llama4's top-1 router, whose one combine weight is 1 whatever the
logits). Each updated weight: where the reference's gradient is beyond
twice that bound (its sign is settled) and above 1e-5 (1000 times AdamW's
eps), both optimizers' first steps are the same function of the gradient
(AdamW's and unfactored Adafactor's a sign times lr), so the weight's change
agrees within 1e-3·lr plus 8 f32 ulps of |w| + lr; elsewhere within 2·lr +
1e-6, since a first step moves a weight by about ±lr and a gradient near
zero may change sign.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro_torch.configs import get_smoke_config
from repro_torch.distributed.steps import make_train_step
from repro_torch.models.params import from_numpy_tree
from repro_torch.training import optimizer as topt
from repro_torch.utils import tree_leaves

LR = 1e-3


def with_grads(optimizer_cls, inner):
    """``inner`` whose state also holds the gradients ``update`` was given:
    ``{"opt": inner's state, "grads": the clipped gradients}``."""
    def update(grads, state, params, step):
        new_params, new_state = inner.update(grads, state["opt"], params, step)
        return new_params, {"opt": new_state, "grads": grads}
    return optimizer_cls(inner.name, inner.spec,
                         lambda params: {"opt": inner.init(params)}, update)


def grad_bounds(ref_grads, rel=3e-4, floor=1e-6):
    """Per leaf: ``rel`` of its largest element plus ``floor`` of the
    largest element of any leaf."""
    top = max(np.abs(g).max() for g in ref_grads)
    return [rel * np.abs(g).max() + floor * top for g in ref_grads]


def assert_leaves_match(olds, news, ref_news, grads, ref_grads, bounds, lr,
                        update_rel):
    """Every leaf's gradient within its bound; every updated weight within
    ``update_rel``·lr plus 8 ulps of |w| + lr of the reference's where the
    reference's gradient's sign is settled and above 1e-5, else 2·lr plus
    one ulp of the result in the weight's dtype."""
    assert len(news) == len(ref_news) == len(grads) == len(ref_grads)
    for i, (w, t, j, g, gj, b) in enumerate(zip(olds, news, ref_news, grads,
                                                ref_grads, bounds)):
        assert t.shape == j.shape == g.shape == gj.shape == w.shape, i
        gerr = np.abs(g - gj)
        assert (gerr <= b).all(), (i, gerr.max(), b)
        ulp = np.finfo(j.dtype).eps if j.dtype == np.float32 else 2.0 ** -7
        settled = (np.abs(gj) > 2 * b) & (np.abs(gj) > 1e-5)
        bound = np.where(settled,
                         update_rel * lr + 8 * 2.0 ** -23 * (np.abs(w) + lr),
                         2 * lr + ulp * (np.abs(w) + lr))
        err = np.abs((t - w) - (j - w))
        assert (err <= bound).all(), (i, float((err - bound).max()))


def train_step_parity(arch):
    from repro.configs import get_smoke_config as jax_cfg
    from repro.configs.base import ShapeSpec
    from repro.data.pipeline import SyntheticLM
    from repro.distributed.steps import make_train_step as jax_step
    from repro.models.registry import get_bundle as jax_bundle
    from repro.training import optimizer as jopt
    jc = jax_cfg(arch)
    S = 24 + (jc.img_tokens if jc.modality == "image_patches" else 0)
    jp = jax.tree.map(lambda a: a.astype(jnp.float32),
                      jax_bundle(jc).init(jax.random.PRNGKey(1)))
    batch = SyntheticLM(jc, ShapeSpec("t", "train", S, 2), seed=0).batch(0)
    jo = with_grads(jopt.Optimizer, jopt.get_optimizer(jc.optimizer, lr=LR))
    jnew, jstate, jm = jax.jit(jax_step(jc, jo, chunk=8))(
        jp, jo.init(jp), {k: jnp.asarray(v) for k, v in batch.items()},
        jnp.asarray(0, jnp.int32))
    tp = from_numpy_tree(jax.tree.map(np.asarray, jp), "cpu")
    opt = with_grads(topt.Optimizer, topt.get_optimizer(jc.optimizer, lr=LR))
    tnew, tstate, tm = make_train_step(get_smoke_config(arch), opt,
                                       device="cpu")(
        tp, opt.init(tp), batch, 0)
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                               rtol=1e-5)
    np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]),
                               rtol=1e-4)
    # the port's trees hold the reference's keys; bridged trees keep jax's
    # sorted key order, so the leaves line up one for one
    ref_grads = [np.asarray(g) for g in jax.tree.leaves(jstate["grads"])]
    assert_leaves_match(
        [t.numpy() for t in tree_leaves(tp)],
        [t.detach().numpy() for t in tree_leaves(tnew)],
        [np.asarray(j) for j in jax.tree.leaves(jnew)],
        [t.numpy() for t in tree_leaves(tstate["grads"])], ref_grads,
        grad_bounds(ref_grads), LR, update_rel=1e-3)


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "gemma2-27b",
                                  "phi4-mini-3.8b", "starcoder2-3b",
                                  "qwen3-moe-235b-a22b",
                                  "llama4-maverick-400b-a17b"])
def test_train_step_matches_reference(arch):
    train_step_parity(arch)

"""qwen2-0.5b at full width (d_model 896, 14 heads over 2, vocab 151,936)
cut to 1 and 4 layers, on the reference's init in f32, one batch (1, 32),
no parameter update: the port's train step against the JAX package's.

Under the reference's init the head projections' std is 1/sqrt(heads), so
at full width the scores are large, the softmax all but one-hot, and the
gradient norm grows steeply with depth; at 24 layers a few AdamW steps do
not move the loss (ROADMAP section 3). This holds the growth in both
packages: more than 100 times from 1 to 4 layers. At 1 layer the port's
loss and gradient norm agree with the reference's within the f32 bounds of
test_torch_train_dense.py (1e-5 and 1e-4 relative); deeper, a last-bit
difference in a score can change which key wins, so the two are not held
to each other there."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from repro_torch.configs import get_config
from repro_torch.distributed.steps import make_train_step
from repro_torch.models.params import from_numpy_tree
from repro_torch.training.optimizer import Optimizer


def _keep(optimizer_cls):
    """An optimizer that leaves the parameters as they are."""
    return optimizer_cls("keep", None, lambda params: {},
                         lambda grads, state, params, step: (params, state))


def _losses_and_norms(layers):
    from repro.configs import get_config as jax_cfg
    from repro.configs.base import ShapeSpec
    from repro.data.pipeline import SyntheticLM
    from repro.distributed.steps import make_train_step as jax_step
    from repro.models.registry import get_bundle as jax_bundle
    from repro.training.optimizer import Optimizer as JaxOptimizer
    jc = dataclasses.replace(jax_cfg("qwen2-0.5b"), num_layers=layers)
    jp = jax.tree.map(lambda a: a.astype(jnp.float32),
                      jax_bundle(jc).init(jax.random.PRNGKey(0)))
    batch = SyntheticLM(jc, ShapeSpec("t", "train", 32, 1), seed=0).batch(0)
    _, _, jm = jax.jit(jax_step(jc, _keep(JaxOptimizer), chunk=32,
                                microbatches=1))(
        jp, {}, {k: jnp.asarray(v) for k, v in batch.items()},
        jnp.asarray(0, jnp.int32))
    tp = from_numpy_tree(jax.tree.map(np.asarray, jp), "cpu")
    del jp
    cfg = dataclasses.replace(get_config("qwen2-0.5b"), num_layers=layers)
    _, _, tm = make_train_step(cfg, _keep(Optimizer), microbatches=1,
                               device="cpu")(tp, {}, batch, 0)
    return ((float(jm["loss"]), float(jm["grad_norm"])),
            (float(tm["loss"]), float(tm["grad_norm"])))


def test_reference_init_gradient_grows_with_depth_at_full_width():
    ref1, got1 = _losses_and_norms(1)
    np.testing.assert_allclose(got1[0], ref1[0], rtol=1e-5)
    np.testing.assert_allclose(got1[1], ref1[1], rtol=1e-4)
    ref4, got4 = _losses_and_norms(4)
    assert np.isfinite(ref4 + got4).all(), (ref4, got4)
    assert ref4[1] > 100 * ref1[1], (ref1, ref4)
    assert got4[1] > 100 * got1[1], (got1, got4)

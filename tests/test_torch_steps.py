"""Port parity for the plain steps (``repro_torch.distributed.steps``), the
entry points of the prefill → decode path: the greedy tokens of
``make_prefill_step`` and ``make_decode_step`` equal those of the JAX
package's steps, in f32, on the JAX package's weights bridged bit-exact
through ``from_numpy_tree`` (smoke-size configs); and the steps default to
the card.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_cfg
from repro.models import lm as jlm
from repro.models.registry import get_bundle as jax_bundle
from repro_torch.configs import get_smoke_config as torch_cfg
from repro_torch.distributed.steps import make_decode_step, make_prefill_step
from repro_torch.models import lm as tlm
from repro_torch.models.params import from_numpy_tree


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "gemma2-27b", "mamba2-130m",
                                  "recurrentgemma-2b", "seamless-m4t-medium",
                                  "llava-next-mistral-7b"])
def test_steps_greedy_tokens_match_reference(arch):
    """make_prefill_step then four make_decode_step steps, each fed its own
    greedy token: the same tokens as the JAX steps, in f32. The prefill
    batch carries seamless's frames and llava's image rows; decode
    continues at the prefilled length (image rows included)."""
    from repro.distributed import steps as jsteps
    jc, tc = jax_cfg(arch), torch_cfg(arch)
    params = jax.tree.map(lambda a: a.astype(jnp.float32),
                          jax_bundle(jc).init(jax.random.PRNGKey(3)))
    pt = from_numpy_tree(jax.tree.map(np.asarray, params), "cpu")
    rng = np.random.default_rng(4)
    toks = rng.integers(0, jc.vocab_size, (2, 21)).astype(np.int32)
    batch = {"tokens": toks}
    if jc.is_encdec:
        batch["frames"] = rng.standard_normal((2, 9, jc.d_model)).astype(
            np.float32)
    if jc.modality == "image_patches":
        batch["image_embeds"] = rng.standard_normal(
            (2, jc.img_tokens, jc.d_model)).astype(np.float32)
    start = toks.shape[1] + (jc.img_tokens if "image_embeds" in batch else 0)
    cache_len = start + 11
    jtok, jcache = jsteps.make_prefill_step(jc, chunk=8, cache_len=cache_len)(
        params, {k: jnp.asarray(v) for k, v in batch.items()})
    ttok, tcache = make_prefill_step(tc, cache_len=cache_len, device="cpu")(
        pt, {k: torch.from_numpy(v) for k, v in batch.items()})
    jdecode, tdecode = jsteps.make_decode_step(jc), make_decode_step(
        tc, device="cpu")
    for cur in range(start, start + 4):
        np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))
        jtok, jcache = jdecode(params, jcache, jtok, cur)
        ttok, tcache = tdecode(pt, tcache, ttok, cur)
    assert ttok.dtype == torch.int32 and ttok.shape == (2, 1)
    np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))


def test_steps_default_to_the_card():
    """The steps' default device is the card, and without one building them
    raises rather than running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    cfg = torch_cfg("qwen2-0.5b")
    with pytest.raises(RuntimeError, match="cuda"):
        make_prefill_step(cfg)
    with pytest.raises(RuntimeError, match="cuda"):
        make_decode_step(cfg)


def test_greedy_sample_matches_reference():
    logits = np.random.default_rng(5).standard_normal((3, 1, 50)).astype(
        np.float32)
    want = jlm.greedy_sample(jnp.asarray(logits))
    got = tlm.greedy_sample(torch.from_numpy(logits))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))

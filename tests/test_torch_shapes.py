"""Abstract shapes and logical axes of the port (``configs/shapes.py``,
``models/params.py``'s ``abstract`` and ``logical_axes``, the bundle's
``abstract_params``, ``cache_abstract`` and ``cache_axes``) against the JAX
package's, for all ten architectures at full width and every ``SHAPES``
entry: the same tree paths, shapes, dtypes and logical axes, exactly.
Nothing is allocated on either side (meta tensors, ShapeDtypeStructs)."""
import jax.numpy as jnp
import pytest
import torch

from repro_torch.configs import ARCH_NAMES, SHAPES, get_config
from repro_torch.configs import shapes as tshapes
from repro_torch.models import params as tparams
from repro_torch.models.registry import get_bundle


def _is_axes(x):
    return isinstance(x, tuple) and all(a is None or isinstance(a, str)
                                        for a in x)


def flat(tree, leaf=lambda x: not isinstance(x, (dict, tuple, list)),
         path=()):
    """{path: leaf} of a dict/tuple tree (dict keys, tuple indices)."""
    if leaf(tree):
        return {path: tree}
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    out = {}
    for k, v in items:
        out.update(flat(v, leaf, path + (k,)))
    return out


def sig(tree):
    """{path: (shape, dtype name)} of a tree of arrays or tensors."""
    def dt(x):
        d = x.dtype
        return (str(d).split(".")[-1] if isinstance(d, torch.dtype)
                else jnp.dtype(d).name)
    return {p: (tuple(x.shape), dt(x)) for p, x in flat(tree).items()}


def axes(tree):
    return flat(tree, leaf=_is_axes)


def _ref(arch):
    from repro.configs import get_config as ref_config
    from repro.models.registry import get_bundle as ref_bundle
    cfg = ref_config(arch)
    return cfg, ref_bundle(cfg)


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_inputs_equal_reference(arch):
    from repro.configs import SHAPES as REF_SHAPES
    from repro.configs import shapes as rshapes
    rcfg, _ = _ref(arch)
    cfg = get_config(arch)
    assert list(SHAPES) == list(REF_SHAPES)
    assert (tshapes.ENCDEC_DEC_LEN, tshapes.ENCDEC_PRIME) == (
        rshapes.ENCDEC_DEC_LEN, rshapes.ENCDEC_PRIME)
    for name, shape in SHAPES.items():
        rshape = REF_SHAPES[name]
        for kind in ("train", "prefill", "decode"):
            got = getattr(tshapes, f"{kind}_inputs")(cfg, shape)
            want = getattr(rshapes, f"{kind}_inputs")(rcfg, rshape)
            assert all(t.device.type == "meta" for t in got.values())
            assert sig(got) == sig(want), (name, kind)
            assert (tshapes.batch_logical_axes(got)
                    == rshapes.batch_logical_axes(want)), (name, kind)
        assert sig(tshapes.inputs_for(cfg, shape)) == sig(
            rshapes.inputs_for(rcfg, rshape)), name
        assert (tshapes.decode_cache_len(cfg, shape)
                == rshapes.decode_cache_len(rcfg, rshape)), name


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_abstract_params_equal_reference(arch):
    from repro.models import params as rparams
    _, rbundle = _ref(arch)
    bundle = get_bundle(get_config(arch))
    got = bundle.abstract_params()
    assert all(t.device.type == "meta" for t in flat(got).values())
    assert sig(got) == sig(rbundle.abstract_params())
    assert sig(tparams.abstract(bundle.spec())) == sig(got)
    assert (axes(tparams.logical_axes(bundle.spec()))
            == axes(rparams.logical_axes(rbundle.spec())))
    is_spec = lambda x: tparams.is_spec(x)   # noqa: E731
    assert all(map(is_spec, flat(bundle.spec(), is_spec).values()))
    assert not tparams.is_spec(got)


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_cache_abstract_and_axes_equal_reference(arch):
    from repro.configs import SHAPES as REF_SHAPES
    from repro.configs import shapes as rshapes
    rcfg, rbundle = _ref(arch)
    cfg = get_config(arch)
    bundle = get_bundle(cfg)
    for name, shape in SHAPES.items():
        if shape.kind != "decode":
            continue
        self_len, cross_len = tshapes.decode_cache_len(cfg, shape)
        B = shape.global_batch
        got = bundle.cache_abstract(B, self_len, cross_len)
        want = rbundle.cache_abstract(B, *rshapes.decode_cache_len(
            rcfg, REF_SHAPES[name]))
        assert all(t.device.type == "meta" for t in flat(got).values())
        assert sig(got) == sig(want), name
        assert (axes(bundle.cache_axes(cross_len))
                == axes(rbundle.cache_axes(cross_len))), name
        # every cache leaf has one logical axis per dim
        ax = axes(bundle.cache_axes(cross_len))
        assert all(len(ax[p]) == len(s[0]) for p, s in sig(got).items())

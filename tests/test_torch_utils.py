"""``repro_torch.utils.tree_params`` and ``human_flops`` against the JAX
package's ``repro.utils``: the parameter count of every architecture's
``Bundle(cfg).spec()`` tree, as a spec tree and as the abstract (meta)
tree of it, at full and smoke size; the flop strings of a few numbers
(zero, each unit's edges, negative, past the last unit)."""
import pytest

from repro_torch.configs import ARCH_NAMES

NUMBERS = [0, 1, 999.994, 999.996, 1000, 123456, 9.874e12, 2.666e13,
           -4.2e9, 1.153e15, 3.2e18, 7e21]


@pytest.mark.parametrize("smoke", [False, True])
@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_tree_params_matches_reference(arch, smoke):
    from repro import configs as ref_configs
    from repro import utils as ref_utils
    from repro.models import params as ref_params
    from repro.models.registry import get_bundle as ref_bundle
    from repro_torch import configs, utils
    from repro_torch.models import params
    from repro_torch.models.registry import get_bundle
    get = configs.get_smoke_config if smoke else configs.get_config
    ref_get = (ref_configs.get_smoke_config if smoke
               else ref_configs.get_config)
    spec, ref_spec = get_bundle(get(arch)).spec(), ref_bundle(
        ref_get(arch)).spec()
    want = ref_utils.tree_params(ref_spec)
    assert want > 0
    assert utils.tree_params(spec) == want
    assert utils.tree_params(params.abstract(spec)) == want
    assert ref_utils.tree_params(ref_params.abstract(ref_spec)) == want


@pytest.mark.parametrize("n", NUMBERS)
def test_human_flops_matches_reference(n):
    from repro import utils as ref_utils
    from repro_torch import utils
    assert utils.human_flops(n) == ref_utils.human_flops(n)

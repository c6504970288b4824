"""One train step of each mixer family (mamba2-130m, recurrentgemma-2b,
seamless-m4t-medium with its frames, llava-next-mistral-7b with its image
rows) through the port's make_train_step against the JAX package's, at
smoke size in f32: every leaf's gradient and update, within the bounds of
test_torch_train_dense.py. mamba2's SSD scan goes through the SSDScan
autograd.Function, whose backward on the CPU is the plain version of the
hand-written kernel the card runs (ssd_scan_bwd_plain)."""
import pytest

from test_torch_train_dense import train_step_parity


@pytest.mark.parametrize("arch", ["mamba2-130m", "recurrentgemma-2b",
                                  "seamless-m4t-medium",
                                  "llava-next-mistral-7b"])
def test_train_step_matches_reference(arch):
    train_step_parity(arch)

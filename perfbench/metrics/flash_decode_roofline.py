"""flash_decode's share of its roofline over the traced window
(kernels/flash_decode.py, csrc/flash_decode.cu)."""
from perfbench.harness.readers import kernel_roofline_pct


def read(rec):
    return kernel_roofline_pct(rec, "flash_decode")

"""Hand-written Hopper kernels for the serving hot path.

* flash_decode — one-token GQA decode against a (possibly ring) KV cache:
  CUDA C++ for sm_90a in ``csrc/flash_decode.cu``, built by ``build.py``
  with nvcc and bound with ctypes, beside its plain PyTorch version.

``ops.py`` holds the model-layout wrappers. A wrapper runs the plain version
only for CPU tensors; on a CUDA tensor it launches its kernel or raises.
"""

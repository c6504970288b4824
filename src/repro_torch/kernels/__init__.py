"""Hand-written Hopper kernels for the serving and training hot paths, each
CUDA C++ for sm_90a under ``csrc/``, built by ``build.py`` with nvcc and
bound with ctypes, beside its plain PyTorch version:

* flash_decode    — one-token GQA decode against a (possibly ring) KV cache
  (``csrc/flash_decode.cu``);
* flash_attention — causal or non-causal attention over a whole sequence,
  for prefill and the train forward (``csrc/flash_attention.cu``), and its
  backward for training (``csrc/flash_attention_bwd.cu``, behind the
  ``FlashAttention`` autograd.Function);
* ssd_scan        — the Mamba2 SSD chunk scan (``csrc/ssd_scan.cu``).

``ops.py`` holds the model-layout wrappers. A wrapper runs the plain version
only for CPU tensors; on a CUDA tensor it launches its kernel or raises.
"""

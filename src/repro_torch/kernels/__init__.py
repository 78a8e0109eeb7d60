"""Hand-written CUDA kernels for Hopper (``csrc/``), each beside its plain
PyTorch version and a launch counter:

  flash_attention   prefill attention (causal / window / GQA, ragged S, T)
  decode_attention  one-token attention over a slotted kv-major cache
  weight_transform  int8 dequant or f32 cast: the A phase of a cold start

Model code calls them through :mod:`repro_torch.kernels.ops`.
"""

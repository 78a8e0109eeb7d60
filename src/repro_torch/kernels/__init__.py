"""Hand-written CUDA kernels for Hopper (``csrc/``), each beside its plain
PyTorch version and a launch counter:

  flash_attention   prefill attention (causal / window / GQA, ragged S, T)
  decode_attention  one-token attention over a slotted kv-major cache
  decode_attention_paged
                    the same over page pools through a page table
  weight_transform  int8 dequant or f32 cast: the A phase of a cold start
  quant_matmul      w8a16 matmul with the dequant fused: int8-resident
                    (compute_quant) projections and head
  ssd_scan          the Mamba-2 SSD chunked scan (initial and final state)
  rglru_scan        the RG-LRU linear recurrence (initial and final state)
  rmsnorm           the reference's rmsnorm, rows independent of the batch
  flash_attention_bwd, rmsnorm_bwd
                    the training backwards of attention and rmsnorm, each
                    behind a torch.autograd.Function

Model code calls them through :mod:`repro_torch.kernels.ops`.
"""

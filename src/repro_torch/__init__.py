"""PyTorch/CUDA port of the Cicada cold-start system (the JAX package
``repro`` is its reference).

Same subpackage layout and public names as ``repro``:

  configs   architecture registry (``models.api.get_config``)
  models    ``ArchConfig``, dense layers, the ``LM`` with its streaming
            unit view
  kernels   hand-written CUDA kernels for Hopper, their plain PyTorch
            versions, and the registry with launch counts (``ops``)
  store     the layer-sharded weight store, byte-compatible with ``repro``
  core      the cold-start pipeline: MiniLoader, WeightDecoupler,
            Priority-Aware Scheduler, execution units, ColdStartEngine
  serving   request types, sampling and ``reference_generate``

Entry points run on the GPU unless given ``device="cpu"`` (see
:mod:`repro_torch.device`).
"""

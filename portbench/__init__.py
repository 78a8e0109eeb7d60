"""The benchmark of ``repro_torch``, the PyTorch and CUDA port of Cicada.

One command (``portbench/run.py``) runs one cell of ``BENCHMARK.json``;
everything a cell needs is found by name in the folders beside this file
(see ``README.md``).  Nothing here imports JAX or the JAX package.
"""

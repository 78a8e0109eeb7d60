"""Concurrency correctness toolkit of the port (a port of
``repro.analysis``).

Two sides share one vocabulary of lock node names ("Class._lock"):

* :mod:`repro_torch.analysis.lint` — AST rules R1–R4 (guarded-by, cv-wait
  discipline, static lock-order cycles, no-sleep).  The reference's R5
  (``jax.jit`` on a bound method) has nothing to check in a package
  without ``jax.jit`` and is left out.
* :mod:`repro_torch.analysis.locks` — the opt-in instrumented Lock /
  RLock / Condition factory (``REPRO_ANALYZE=1``) every module of the
  port uses, plus the process-wide :data:`~repro_torch.analysis.locks.probe`.

``python -m repro_torch.analysis {lint,lockgraph,report}`` is the CLI.
"""
from repro_torch.analysis.locks import (enabled, make_condition, make_lock,
                                        make_rlock, note_io, probe)

__all__ = ["enabled", "make_lock", "make_rlock", "make_condition",
           "note_io", "probe"]

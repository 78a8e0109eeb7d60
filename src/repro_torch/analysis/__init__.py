"""Concurrency helpers of the port (the lock factory)."""
from repro_torch.analysis.locks import (make_condition, make_lock,  # noqa: F401
                                        make_rlock)

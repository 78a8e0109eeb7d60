"""Readers of the end-to-end metrics: each ``read(rec) -> float | None``
from the run's records, on the host's clock.  ``setup_s`` is the run's
own."""

"""Readers of the per-layer metrics: each ``read(rec) -> float | None``,
None where the run has nothing to read (a roofline or a share of a peak
is then left out, never 0)."""

"""Tools that set the benchmark's numbers; the runs themselves never
use them (see ``README.md``)."""

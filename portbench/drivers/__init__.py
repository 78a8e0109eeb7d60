"""Drivers: how a cell's traffic reaches the port.  Each module has
``setup(ctx) -> state`` (weights, the program's objects, the warm-up),
``window(ctx, state) -> records`` (the measured window, and the drain of
what it admitted) and ``close(state)`` (drops the program's state)."""

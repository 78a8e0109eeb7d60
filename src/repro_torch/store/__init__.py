"""Weight store of the port (``store.store``)."""

"""Weight store of the port (``store.store``) and the node-local shared
``WeightCache`` of retrieved unit leaves (``store.cache``)."""

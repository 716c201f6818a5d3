"""Models: the APPNP MLP tower and forward."""

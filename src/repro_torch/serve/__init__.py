"""LM serving: the slot engine (``serve.engine.ServeEngine``)."""

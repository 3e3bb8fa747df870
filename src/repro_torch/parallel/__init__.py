"""The LM meshes of the port: ``mesh`` (constructors, the parallelism
strategy, the batch axes), ``sharding`` (the logical-axis rules: param,
optimizer-state, batch and cache specs by path) and ``act_sharding`` (the
activation hooks and the per-layer ZeRO-3 weight gather)."""

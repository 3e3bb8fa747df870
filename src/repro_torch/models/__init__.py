"""The LM scaffolding's models in PyTorch: ``config`` (``ModelConfig``),
``layers``, ``attention``, ``flash`` (forward), ``moe``, ``mamba``,
``transformer`` (dense / MoE / SSM / hybrid / VLM) and ``registry``
(``make_arch``).  The encoder-decoder family is not ported yet."""

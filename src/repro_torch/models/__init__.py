"""The LM scaffolding's models in PyTorch: ``config`` (``ModelConfig``),
``layers``, ``attention``, ``flash`` (with its memory-exact backward),
``moe``, ``mamba``, ``transformer`` (dense / MoE / SSM / hybrid / VLM),
``encdec`` (the encoder-decoder family) and ``registry`` (``make_arch``,
``input_specs``)."""

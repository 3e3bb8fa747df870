"""Training: ``checkpoint`` (atomic, keep-k, async, self-validating),
``optim`` (AdamW, Adafactor, SGD with momentum, LR schedules), ``loss``,
``data``, ``step`` and ``loop`` (the LM train path of ``repro.train`` on
one device)."""

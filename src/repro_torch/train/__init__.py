"""Training-side utilities of the port: ``checkpoint`` (the CRRM part of
``repro.train``) and ``optim`` (the AdamW of the RL stack); the LM
scaffolding waits for its slice."""

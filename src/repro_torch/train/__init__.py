"""Training-side utilities of the port: so far only ``checkpoint`` (the
CRRM part of ``repro.train``; the LM scaffolding waits for its slice)."""

"""Launchers of the port: ``dryrun`` runs the crrm-ppp cells on one
device; ``serve`` serves an LM through ``serve.engine.ServeEngine``.  The
LM training and mesh launchers (``train``, ``mesh``) wait for the LM
training slice."""

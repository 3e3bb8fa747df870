"""Launchers of the port: ``dryrun`` runs the crrm-ppp cells on one
device.  The LM launchers (``mesh``, ``serve``, ``train``) wait for the
LM scaffolding's slice."""

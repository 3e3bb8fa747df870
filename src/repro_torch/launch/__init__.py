"""Launchers of the port: ``dryrun`` runs the crrm-ppp cells on one
device and reckons the LM cells over the named meshes; ``serve`` serves an
LM through ``serve.engine.ServeEngine``; ``train`` trains one through
``train.loop.train`` on a mesh of the default process group; ``mesh``
names the production meshes."""

"""Measurement tools of the port (counterparts of the repository's
``tools/`` probes); each runs on the card unless ``--device cpu`` asks for
the plain versions."""

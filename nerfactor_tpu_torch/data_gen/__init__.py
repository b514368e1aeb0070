"""Data generation of the port: the DTU MVS ingestion
(dtu_surf_from_mvs) with its camera, PLY reader and ray tracer."""

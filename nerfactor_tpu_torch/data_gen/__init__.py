"""Data generation of the port: the dataset converters (a COLMAP/LLFF
capture, a DTU scan in its processed or raw layout, MERL binaries), the
synthetic scenes' Blender renderer, and the DTU MVS ingestion
(dtu_surf_from_mvs) with its camera, PLY reader and ray tracer."""

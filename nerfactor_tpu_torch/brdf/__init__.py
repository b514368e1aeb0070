"""MERL helpers and the sphere renderer (NumPy copies of brdf_tpu/merl.py
and brdf_tpu/renderer.py, the parts the BRDF prior's visualization and
test table need)."""

"""The benchmark of nerfactor_tpu_torch on one H100: see run.py."""

"""Manual debugging harnesses of the port (counterpart of
nerfactor_tpu/debug/)."""

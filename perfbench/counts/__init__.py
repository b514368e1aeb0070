"""Operation and byte counts of the kernels and model steps."""

"""nerfactor_tpu_torch: the PyTorch + CUDA port of nerfactor_tpu.

The JAX package ``nerfactor_tpu`` is the reference and stays unchanged.
This package mirrors its module names, imports ``torch`` and never
``jax``, and replaces each Pallas TPU kernel on the ported path with a
CUDA kernel written for Hopper (``csrc/``). Ported so far: inference and
training of the joint NeRFactor model (``python -m
nerfactor_tpu_torch.test``, ``python -m nerfactor_tpu_torch.trainvali``).
"""

__version__ = "0.1.0"

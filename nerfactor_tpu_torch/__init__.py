"""nerfactor_tpu_torch: the PyTorch + CUDA port of nerfactor_tpu.

The JAX package ``nerfactor_tpu`` is the reference and stays unchanged.
This package mirrors its module names, imports ``torch`` and never
``jax``, and replaces each Pallas TPU kernel on the ported path with a
CUDA kernel written for Hopper (``csrc/``). Ported so far: training and
test rendering of NeRF (``python -m nerfactor_tpu_torch.trainvali
--config=nerf.ini``, ``python -m nerfactor_tpu_torch.nerf_test``), and
inference and training of the joint NeRFactor model (``python -m
nerfactor_tpu_torch.test``, ``--config=nerfactor.ini``).
"""

__version__ = "0.1.0"

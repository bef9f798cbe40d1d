"""probav_tpu_torch — the PyTorch / CUDA port of ``probav_tpu``.

The serving path of the flagship WDSR-B model, on PyTorch with
hand-written Hopper kernels for the block stack:

- ``probav_tpu_torch.models``   ``WDSRConv3D`` and its weight-normalized
                                 layers (flax parameter names and layouts).
- ``probav_tpu_torch.ops``      the stack kernels (``tstack``, CUDA sources
                                 in ``csrc/``) and the pixel shuffle.
- ``probav_tpu_torch.infer``    the scene resolver and submission writer.
- ``probav_tpu_torch.convert``  flax parameter tree <-> ``state_dict``.
- ``probav_tpu_torch.serve``    the ``test.py`` counterpart CLI.

Importing the package (or any module of it) initializes no CUDA context,
builds no kernel and needs neither JAX nor triton: kernels are built at
their first launch.
"""

__version__ = "0.1.0"

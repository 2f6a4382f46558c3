"""Kernels of the UFA sweep path, each with its plain PyTorch version:

  * ``reduce``      — the segmented timeline verdict reduction;
  * ``propagation`` — the ELL failure-propagation round, iterated to a
    fixed point.
"""

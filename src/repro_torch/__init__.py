"""PyTorch/CUDA port of the UFA failover reproduction.

Mirrors ``repro``'s module map.  Host code with no device work is kept
as its own copy; the array paths run on PyTorch tensors, and every
Pallas kernel on a ported path is a CUDA kernel written for Hopper
(``csrc/``), built at first use.  Entry points take ``device=`` and run
on the CUDA card unless the caller names the CPU.
"""

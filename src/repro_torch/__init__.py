"""repro_torch — the PyTorch/CUDA port of the MDMP reproduction.

A second package beside ``repro`` (the JAX reference).  It mirrors
``repro``'s module layout and public names, imports ``torch`` and numpy
and never ``jax`` or ``repro``.  Every TPU Pallas kernel on a ported path
becomes a hand-written CUDA kernel for Hopper (``kernels/csrc``) with a
plain PyTorch version beside it; a wrapper launches the kernel for a CUDA
tensor and takes the plain version only for a CPU tensor.

Entry points run on ``cuda`` unless the caller asks for the CPU
(``device="cpu"`` / ``--device cpu``); see :func:`repro_torch.device.
resolve_device`.
"""

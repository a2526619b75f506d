"""PyTorch + CUDA port of the ``repro`` package for one NVIDIA H100.

Module names and layout follow ``src/repro`` so each port module sits where
its JAX counterpart does.  Plain tensor code is PyTorch; every TPU Pallas
kernel on a ported path is a hand-written CUDA kernel under ``csrc/``,
dispatched by ``kernels/ops.py`` on the device of its input tensor.
Entry points default to the card (``device="cuda"``); the CPU runs only
when a caller passes ``device="cpu"``.
"""

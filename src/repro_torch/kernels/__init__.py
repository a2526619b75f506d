"""Hand-written CUDA kernels for the TPU Pallas kernels, with their plain
PyTorch versions.  ``ops`` dispatches on the input tensor's device.  (No
re-exports here: ``ops.flash_attention`` would shadow the
``flash_attention`` submodule.)"""

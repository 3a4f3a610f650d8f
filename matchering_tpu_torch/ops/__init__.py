"""DSP ops of the port: plain PyTorch on the caller's device, with the two
hand-written CUDA kernels behind ``sliding``/``iir`` callers (see
``matchering_tpu_torch.kernels``)."""

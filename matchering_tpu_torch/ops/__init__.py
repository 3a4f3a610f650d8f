"""DSP ops of the port: plain PyTorch on the caller's device, with the
hand-written CUDA kernels behind the limiter's ``iir`` calls (see
``matchering_tpu_torch.kernels``)."""

"""tpu-plonk's prover ported to PyTorch + hand-written CUDA kernels for
an NVIDIA H100 (sm_90a).  The JAX package `tpu_plonk` beside it is the
reference the port is tested against; nothing here imports it."""

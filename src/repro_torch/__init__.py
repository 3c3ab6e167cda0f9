"""PyTorch/CUDA port of the ``repro`` serving system (dense decoders, wave
scheduler, hand-written Hopper kernels).  Imports torch and numpy, never jax."""

"""PyTorch/CUDA port of `mico_tpu` for one NVIDIA H100.

The package mirrors `mico_tpu`'s module names; the JAX package is the
reference it is held against and is never imported here. Entry points:
`mico_tpu_torch.models.mico.MiCo` and `mico_tpu_torch.serve.EmbeddingPipeline`
(both run on CUDA unless given `device="cpu"`). The attention kernels of the
main path are hand-written for Hopper (`csrc/`) and built at first use.
"""

"""dfc_sa_unet_torch - the DFC-SA U-Net in PyTorch with hand-written CUDA
kernels for one NVIDIA H100.

A port of dfc_sa_unet_tpu (JAX/Flax/Pallas), which stays beside it as the
reference.  The package imports torch, numpy and the standard library
only.  Entry points run on the card and raise without CUDA unless they
are given ``device="cpu"``.
"""

__version__ = "0.1.0"

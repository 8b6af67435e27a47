"""PyTorch + CUDA port of ``vfd_gan_tpu`` for NVIDIA Hopper (H100).

The JAX package beside it is the reference.  This package imports ``torch``
and never ``jax``; its public ops keep the JAX functions' signatures and
channel-last ``(B, T, H, W, C)`` layout, its modules take NCDHW input and use
the reference's ``state_dict`` key names.
"""

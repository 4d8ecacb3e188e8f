"""Host-side image/box transforms: the JAX package's numpy transforms (no
jax), reused unchanged."""

from vlbert_tpu.data.transforms import build_transforms

__all__ = ["build_transforms"]

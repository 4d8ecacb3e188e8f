"""Experiment configs: the JAX package's yaml loader and defaults (plain
Python, no jax), reused unchanged so both packages read one config
format."""

from vlbert_tpu.utils.config import default_config, load_config

__all__ = ["default_config", "load_config"]

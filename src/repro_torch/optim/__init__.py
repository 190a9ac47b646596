"""Optimizers (torch port): AdamW with the JAX package's update."""

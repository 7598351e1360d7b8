"""Weight conversion into the port's modules: CompVis checkpoints
(``from_torch``) and the JAX package's parameter trees (``from_jax``)."""

"""Latent diffusion core and the text-guided stochastic translate pipeline."""

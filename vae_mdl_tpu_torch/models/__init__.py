"""Model configs, the VAE module and its objective."""

"""MusicLDM models in PyTorch (port of `diffmusic_tpu/models`): UNet, VAE
decoder, HiFi-GAN, and the weight carry from the JAX package."""

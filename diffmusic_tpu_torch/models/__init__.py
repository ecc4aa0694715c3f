"""The port's models in PyTorch (port of `diffmusic_tpu/models`): UNet, VAE
decoder, HiFi-GAN, the AudioLDM2 text stack (CLAP text tower, T5 encoder or
the TTS variant's VITS, projection model, GPT-2), the CLAP audio tower
(HTSAT) with its input features, and the weight carry from the JAX package."""

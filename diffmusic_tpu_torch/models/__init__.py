"""The port's models in PyTorch (port of `diffmusic_tpu/models`): UNet, VAE
decoder, HiFi-GAN, the AudioLDM2 text stack (CLAP text tower, T5 encoder,
projection model, GPT-2), and the weight carry from the JAX package."""

"""AudioSR-class latent-diffusion super-resolver: model and runtime."""

"""Acoustic model (inference) and HiFi-GAN generator."""

"""Training and evaluation steps on one device."""

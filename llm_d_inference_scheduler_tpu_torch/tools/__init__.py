"""Scripts of the PyTorch port that run on the card (A/B timing)."""

"""Training-side modules of the port (the embedding slice: the SSL model's forward)."""

"""Models of the port (LLaMA, for serving and training)."""

"""Models of the port (slice 1: LLaMA for serving)."""

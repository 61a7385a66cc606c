"""Model definitions (Llama family)."""

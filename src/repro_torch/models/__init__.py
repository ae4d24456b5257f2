"""Model assembly: the dense decoder-only LM."""

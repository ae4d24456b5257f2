"""The serving entry point (``run_once``, ``main``) and the model-FLOPs
arithmetic."""

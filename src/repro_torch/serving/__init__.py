"""Serving engine, virtual clock, accelerator lane model and remote data
service."""

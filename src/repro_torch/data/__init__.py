"""Synthetic semantic world and request workloads."""

"""Cortex core: Semantic Elements, Seri two-stage retrieval, the semantic
cache (LCFU + TTL), Markov prefetching and threshold recalibration."""

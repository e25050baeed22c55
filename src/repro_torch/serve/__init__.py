"""Serving: KV caches, one-pass prefill, decode steps."""

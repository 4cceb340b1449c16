"""Serving: continuous-batching admission."""

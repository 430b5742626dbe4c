"""Utilities: seeded test-input generators."""

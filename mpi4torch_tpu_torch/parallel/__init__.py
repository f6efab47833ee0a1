"""Parallelism helpers."""

"""Shared pieces of the harness: traffic, weights, work counts, trace reduction."""

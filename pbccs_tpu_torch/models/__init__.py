"""Consensus models."""

"""Indexes."""

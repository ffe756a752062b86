"""Render orchestration."""

"""Fusion modules (torch): Pyramid Fusion."""

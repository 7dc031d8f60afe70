"""The eval runtime."""

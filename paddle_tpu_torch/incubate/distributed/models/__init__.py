"""Incubate distributed models of the port: ``moe``."""

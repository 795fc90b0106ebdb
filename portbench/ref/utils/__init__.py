"""Frozen copy; see portbench/ref/__init__.py."""

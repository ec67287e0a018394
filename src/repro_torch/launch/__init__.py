"""Launchers: the ``transferd`` command-line entry point."""

"""Launchers: the ``transferd`` command-line entry point, and the dense
transformer's ``train`` and ``serve`` launchers with their ``steps``."""

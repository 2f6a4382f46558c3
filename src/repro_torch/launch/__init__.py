"""Command-line launchers of the port (``repro/launch``)."""

"""Command-line entry points of the port (``python -m ...script.<name>``)."""

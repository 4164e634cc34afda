"""Command-line tools of the port: the tuning sweep and the tuning-table CLI."""

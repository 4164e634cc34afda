"""Grid layouts of the port: ``sharding.py``."""

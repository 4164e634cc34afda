"""Model configs (the port's copies) and the ``tuning/default.json`` table."""

"""Utilities of the port: the layered run config and `hps.json`, logging
and the running loss meters."""

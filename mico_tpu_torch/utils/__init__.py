"""Utilities of the port: the layered run config and `hps.json`, logging,
the running loss meters and the pretrained checkpoint registry."""

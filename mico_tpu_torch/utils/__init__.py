"""Utilities of the port: the `hps.json` reader of a run directory."""

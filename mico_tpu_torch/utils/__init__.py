"""Utilities of the port: the layered run config and `hps.json`, logging,
the running loss meters, the pretrained checkpoint registry and profiling
(`profiling.trace`, `annotate`, `StepTimer`, the FLOP counts)."""

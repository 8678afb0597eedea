"""Workload sources of the torch port: synthetic LUBM-shaped graphs and
N-Triples ingest."""

"""Seeded generators of every cell's work. Each reads the parameters of
its mix from the workload file (`workloads/<cell>.json`, key
``traffic``); the same seed gives the same work, and every seed the same
sizes."""

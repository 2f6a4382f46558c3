"""The failover system: fleet, capacity, orchestrator, and the fused
scenario sweep."""

"""The README's ten example drivers on the port (``examples/*.py`` of the
reference, one module each under the same name).

Each runs as ``python -m repro_torch.examples.<name> [flags] [--device
cuda|cpu]`` and has a ``main(argv=None)``.  It takes its reference
driver's flags plus ``--device`` (default ``cuda``; raises without a
card, ``cpu`` runs the plain PyTorch path when asked for) and prints its
reference driver's lines in the same order and format: only wall times,
rates and the device's name differ, and lines that depend on the random
weights (losses, the model's tokens) follow the port's own seeded
weights.  ``compare`` holds two outputs to each other by those rules.

Importing a driver does nothing: its work is all under ``main()``.
"""

NAMES = ("harden_fleet", "temporal_sweep", "chaos_campaign",
         "live_failover_drill", "optimize_capacity", "capacity_planner",
         "failover_drill", "serve_batched", "quickstart", "train_multihost")

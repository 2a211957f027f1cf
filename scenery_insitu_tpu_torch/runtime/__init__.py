"""The in-situ session loop, its failure isolation, async delivery,
timers and checkpoints."""

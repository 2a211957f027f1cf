"""The in-situ session loop, its failure isolation, async delivery,
timers and checkpoints; the streaming and steering edges, the head node
and the render benchmark tools."""

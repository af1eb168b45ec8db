"""Run logging, metrics, plots and checkpoints of the train loop."""
